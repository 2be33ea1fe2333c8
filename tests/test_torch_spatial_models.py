"""PSPNet, CCT and the ``sreg`` task (``unet_lite``) under the port's
spatial partitioning (``--spatial-train``, ``--spatial-val``), against one
process and against the JAX package's GSPMD step.

Ranks run over gloo as processes of ``tests/_torch_spatial_worker.py``:
one run of two ranks for everything on a 1 x 2 grid (the layers, the
steps and the scripts, in turn in one process group) and one of four for
CCT on a 2 x 2 grid, each made once for every xdist worker
(``test_torch_spatial._shared``); the tests read their verdicts.

* Layers, two ranks against one process (``worker.MODEL_LAYER_CASES``):
  the ``align_corners=False`` resize up (33 -> 65) and down (65 -> 17), the
  adaptive pool's bins (1, 2, 3, 6) over 5 and 3 rows, the x2 pixel shuffle
  at odd heights, the nearest resize across the boundary, the PSP module
  and the decoder in training (the pooled bins' gradient and BN
  statistics, counted once over the group), the ``'SAME'`` stride-2
  ``ConvBNRelu`` at 32 and 33 rows, the guided cutout on masks whose
  components cross the boundary (the spiral and the blobs of
  ``tests/test_torch_cct.py``), the masking decoders' mask, VAT through a
  decoder and the feature drop: output, input gradient, parameter
  gradients summed over the ranks and BN statistics, atol and rtol 1e-5;
  the masks exactly.
* Two train steps under ``--spatial-train 2`` against one process on the
  global batch, with ``tests/test_torch_parallel.py``'s limits: PSPNet /
  ResNet-10 at 65 px (a 5-row latent, split 3/2) with SupOnly, MT,
  AdvSSL, S4L, CutMix and CCT (one decoder of each of the seven families,
  VAT at ``xi`` 1e-1), GCT on PSPNet at 96 px (6 blurs a step on each
  rank's strip), and ``sreg`` SupOnly, MT and S4L at 32 px, base 8; CCT
  also on a 2 x 2 grid of four ranks. PSPNet SupOnly at 32 px and
  ``sreg`` MT (``tests/test_task_sreg.py``'s configuration) also equal
  the JAX package's step on ``make_mesh_2d(2, devices=jax.devices()[:2])``.
* ``run_script`` of the PSPNet 1-8 SupOnly script (on the VOC fixture
  tree) and of the ``sreg`` demo script (MT) with ``--distributed
  --spatial-train 2 --visualize`` trains like one process and writes one
  process's PNGs (``tests/test_torch_spatial.py``'s limits); the ``sreg``
  script's ``--validation --spatial-val`` at 36 px counts exactly ``n *
  36 * 36`` valid pixels (the padded rows' GT is ``--ignore-index``) and
  scores like one process; PSPNet's ``--validation --spatial-val
  --visualize`` writes one process's PNGs and scores.
"""

import collections
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from pixelssl_tpu import harness as jax_harness
from pixelssl_tpu import parallel as jax_parallel

from pixelssl_tpu_torch import harness, parallel
from pixelssl_tpu_torch.models.convert import from_jax
from pixelssl_tpu_torch.scripts import sreg_synthetic_sslmt

import _torch_spatial_worker as worker
import test_torch_spatial as base
from test_torch_cct import _blobs, _spiral
from test_torch_mt import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = base.NUM_CLASSES
STEPS = base.STEPS
ITERS_PER_EPOCH = base.ITERS_PER_EPOCH
# one run of two ranks does every 1 x 2 check of this file
TIMEOUT = 600


def _masks():
    """The cutout cases' [B,H,W] masks: the spiral and the blobs of
    ``tests/test_torch_cct.py`` (each split by the ranks' boundary), the
    spiral also mirrored."""
    spiral = _spiral(41)
    return {'cutout_spiral': np.concatenate([spiral, spiral[:, ::-1]]),
            'cutout_blobs': np.concatenate([_blobs(0),
                                            _blobs(1, thresh=0.85)])}


def _layer_verdicts(ranks, masks):
    worker.CUT_MASKS.update(masks)
    verdicts = {}
    for case in worker.MODEL_LAYER_CASES:
        parts = [r['layers'][case] for r in ranks]
        verdicts[case] = base._failures(_check_layer, case, parts)
    return verdicts


def _check_layer(case, parts):
    ref = worker.run_layer(*case)
    exact = case[0].startswith(('cutout', 'guided'))
    for key, dim in (('out', ref['out_dim']), ('grad', ref['h_dim'])):
        for got in ([p[key] for p in parts] if dim is None else
                    [torch.cat([p[key] for p in parts], dim)]):
            if exact:
                assert torch.equal(got, ref[key]), key
            np.testing.assert_allclose(got.numpy(), ref[key].numpy(),
                                       atol=base.LAYER_TOL,
                                       rtol=base.LAYER_TOL, err_msg=key)
    assert set(parts[0]['params']) == set(ref['params'])
    for name, value in ref['params'].items():
        got = sum(p['params'][name] for p in parts)
        np.testing.assert_allclose(got.numpy(), value.numpy(),
                                   atol=base.LAYER_TOL, rtol=base.LAYER_TOL,
                                   err_msg=name)
    for name, value in ref['buffers'].items():
        for p in parts:
            np.testing.assert_allclose(
                p['buffers'][name].float().numpy(), value.float().numpy(),
                atol=base.LAYER_TOL, rtol=base.LAYER_TOL, err_msg=name)
    if exact:  # the masks cut something, and not everything
        assert bool((ref['out'] == 0).any()) and bool((ref['out'] != 0).any())


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

PSP = dict(models={'model': 'pspnet'}, optimizers={'model': 'sgd'},
           lrers={'model': 'polynomiallr'},
           criterions={'model': 'sseg_criterion'})
MT_ARGS = dict(batch_size=4, unlabeled_batch_size=2, ignore_unlabeled=False,
               cons_for_labeled=True, cons_scale=1.0, cons_rampup_epochs=1,
               ema_decay=0.99, gaussian_noise_std=0.1)
CCT_ARGS = dict(batch_size=4, unlabeled_batch_size=2, ignore_unlabeled=False,
                cons_scale=30.0, cons_rampup_epochs=0, ad_lr_scale=10.0,
                vat_dec_num=1, vat_dec_xi=1e-1, drop_dec_num=1,
                cut_dec_num=1, context_dec_num=1, object_dec_num=1,
                fd_dec_num=1, fn_dec_num=1)
SREG = dict(task='sreg', base_channels=8, lr=0.01)
# name: (algorithm, height, arguments); PSPNet at 65 px (a 5-row latent)
STEP_RUNS = {
    'psp_null': ('ssl_null', 65, dict(PSP, batch_size=4,
                                      unlabeled_batch_size=0)),
    'psp_mt': ('ssl_mt', 65, dict(PSP, **MT_ARGS)),
    'psp_adv': ('ssl_adv', 65, dict(PSP, **base.ADV_ARGS)),
    'psp_s4l': ('ssl_s4l', 65, dict(PSP, **base.STEP_RUNS['ssl_s4l'][2])),
    'psp_cutmix': ('ssl_cutmix', 65, dict(
        PSP, **base.STEP_RUNS['ssl_cutmix'][2])),
    'psp_cct': ('ssl_cct', 65, dict(PSP, **CCT_ARGS)),
    'psp_gct': ('ssl_gct', 96, dict(PSP, **base.STEP_RUNS['ssl_gct'][2])),
    'psp_null_jax': ('ssl_null', 32, dict(PSP, batch_size=4,
                                          unlabeled_batch_size=0)),
    'sreg_null': ('ssl_null', 32, dict(SREG, batch_size=4,
                                       unlabeled_batch_size=0)),
    # tests/test_task_sreg.py::test_sreg_spatial_train_step's
    # (without its input noise: the two packages' generators differ)
    'sreg_mt': ('ssl_mt', 32, dict(SREG, **dict(
        MT_ARGS, cons_for_labeled=False, epochs=1, gaussian_noise_std=0.0))),
    # the rotation head on the latent, a quarter of the input's height
    'sreg_s4l': ('ssl_s4l', 32, dict(SREG, **base.STEP_RUNS['ssl_s4l'][2])),
}
# from the JAX package's initial weights, and against its GSPMD step
JAX_RUNS = ('psp_null_jax', 'sreg_mt')
GRID_RUNS = ('psp_cct',)


def _spec(name):
    algorithm, h, extra = STEP_RUNS[name]
    args = dict(backbone='resnet10', im_size=h, num_classes=NUM_CLASSES,
                bf16=False, lr=5e-5, momentum=0.9, weight_decay=5e-4,
                power=0.9, epochs=20, seed=3)
    args.update(extra)
    return algorithm, h, args


def _global_batch(args, seed):
    rng = np.random.default_rng(seed)
    n, im = args['batch_size'], args['im_size']
    lbs = n - args['unlabeled_batch_size']
    images = rng.standard_normal((n, im, im, 3)).astype(np.float32)
    if args.get('task') == 'sreg':
        labels = rng.uniform(0.0, 1.0, (n, im, im, 1)).astype(np.float32)
        labels[lbs:] = 0.0
        return images, labels
    labels = rng.integers(0, NUM_CLASSES, (n, im, im)).astype(np.int32)
    labels[:lbs, :4, :4] = 255
    labels[lbs:] = -1
    return images, labels


def _job(name):
    """The run's job: its global batch, and for ``JAX_RUNS`` the JAX
    package's initial weights (else every rank builds them from the seed,
    as one process does)."""
    algorithm, _, args_dict = _spec(name)
    run = dict(algorithm=algorithm, args=args_dict)
    if name in JAX_RUNS:
        jargs = jax_harness.default_args(algorithm, **args_dict)
        jalgo = jax_harness.build_algorithm(
            jargs, mesh=jax_parallel.make_mesh(1),
            iters_per_epoch=ITERS_PER_EPOCH)
        initial = jax.tree.map(np.asarray, jax.device_get(jalgo.state))
        modules = harness.build_algorithm(harness.default_args(
            algorithm, **args_dict), device='cpu').modules
        run['states'] = {key: from_jax(initial[key]) for key in modules}
    run['images'], run['labels'] = _global_batch(args_dict, len(name))
    return run


def _one_process(run):
    """The port's steps in one process on the run's global batch: the
    metrics of each step and the final states."""
    args = harness.default_args(run['algorithm'], **run['args'])
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=ITERS_PER_EPOCH)
    for key, state in run.get('states', {}).items():
        algo.modules[key].load_state_dict(state)
    batch = harness._to_batch(run['images'], run['labels'], 'cpu')
    one = [{k: float(v) for k, v in algo.train_step(batch).items()}
           for _ in range(STEPS)]
    return one, {k: m.state_dict() for k, m in algo.modules.items()}


# ---------------------------------------------------------------------------
# scripts
# ---------------------------------------------------------------------------

def _psp_script_config(out):
    """The PSPNet 1-8 SupOnly script's config on the VOC fixture tree,
    trained from scratch: ResNet-10 at 65 px, one epoch (2 iterations of
    the script's batch of 4 over the 10 labeled images) and the validation
    of the 4 val images."""
    path = os.path.join(REPO, 'pixelssl_tpu_torch', 'scripts',
                        'pspnet_pascalvoc_1-8_suponly.py')
    spec = importlib.util.spec_from_file_location('psp_suponly', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fixture = os.path.join(REPO, 'tests', 'data', 'voc_fixture', 'VOC2012')
    config = collections.OrderedDict(module.config)
    config.update(
        trainset={'pascal_voc_aug': [fixture]},
        valset={'pascal_voc_aug': [fixture]},
        sublabeled_path=os.path.join(REPO, 'dataset', 'PascalVOC',
                                     'sublabeled_prefix', '1-8', '0.txt'),
        validation=False, resume='', out_path=str(out), epochs=1,
        backbone='resnet10', im_size=65, train_base_size=65, bf16=False,
        num_workers=0, log_freq=1, checkpoint_freq=10)
    return config


def _sreg_config(out, **overrides):
    """The ``sreg`` demo script's MT config (``unet_lite`` base 32 at 64
    px, Adam) on 8 samples, one epoch."""
    config = sreg_synthetic_sslmt.make_config('ssl_mt', str(out), epochs=1)
    config.update(synthetic_samples=8, log_freq=1, bf16=False)
    config.update(overrides)
    return config


SREG_VAL = dict(ssl_algorithm='ssl_null', unlabeled_batch_size=0,
                validation=True, im_size=36, synthetic_samples=6,
                spatial_val=True)


def _psp_val_config(out, sub):
    return base._script_config(out, sub, **dict(
        base.VISUAL_VAL, models={'model': 'pspnet'}, visualize=True,
        synthetic_samples=4))


def _run_one(config, task='sseg'):
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sreg, sseg
    module, proxy = ((sreg, sreg.PixelRegressionProxy) if task == 'sreg'
                     else (sseg, sseg.SemanticSegmentationProxy))
    return pixelssl_tpu_torch.run_script(dict(config), module, proxy,
                                         device='cpu', cli_override=False)


def _meters(proxy):
    return {k: m.avg for k, m in proxy.ssl_algorithm.meters.items()
            if 'metric' in k or k.endswith('_loss')}


def _check_scores(ranks, one):
    for out in ranks:
        assert set(out['meters']) == set(one)
        for key, value in one.items():
            if key.endswith('_loss'):
                assert np.isclose(out['meters'][key], value, rtol=1e-6), key
            else:
                assert abs(out['meters'][key] - value) <= base.SCORE_ATOL, key


def _script_jobs(root):
    """The script jobs of the two ranks, and for each a function that runs
    it in one process and returns the check of the ranks' outputs against
    that run."""
    jobs, checks = [], collections.OrderedDict()
    sub = root / 'sub.txt'
    sub.write_text('synthetic_00000\nsynthetic_00002\n')
    # the PSPNet and sreg scripts under --spatial-train 2, the first
    # iteration and the first val batch visualized
    for name, config, task in (
            ('psp script', _psp_script_config, 'sseg'),
            ('sreg script', _sreg_config, 'sreg')):
        jobs.append(dict(kind='script', task=task, return_states=False,
                         config=dict(config(root / name / 'two'),
                                     distributed=True, spatial_train=2,
                                     visualize=True)))

        def make(name=name, config=config, task=task):
            exp_id = _run_one(dict(config(root / name / 'one'),
                                   visualize=True), task).args.exp_id
            one = base._records(root / name / 'one' / exp_id /
                                'metrics.jsonl')
            one_pngs = base._visual_pngs(root / name / 'one', exp_id)
            train = [r for r in one if r['phase'] == 'train']

            def check(ranks):
                base._check_records(base._records(
                    root / name / 'two' / exp_id / 'metrics.jsonl'), one)
                assert len(train) >= 2
                for out in ranks:
                    assert (out['n_devices'], out['step']) == (1, len(train))
                base._check_pngs(base._visual_pngs(root / name / 'two',
                                                   exp_id), one_pngs)
                assert any(n.startswith('train/') for n in one_pngs)
                assert any(n.startswith('val/') for n in one_pngs)
            return check
        checks[name] = make
    # sreg --validation --spatial-val at 36 px
    jobs.append(dict(kind='script', task='sreg', return_states=False,
                     config=dict(_sreg_config(root / 'sreg val' / 'two',
                                              **SREG_VAL), distributed=True)))

    def make_sreg_val():
        one = _meters(_run_one(_sreg_config(root / 'sreg val' / 'one',
                                            **SREG_VAL), 'sreg'))

        def check(ranks):
            _check_scores(ranks, one)
            for out in ranks:
                (sums,) = out['sums'].values()
                assert float(sums[2]) == \
                    SREG_VAL['synthetic_samples'] * 36 * 36
        return check
    checks['sreg val'] = make_sreg_val
    # PSPNet --validation --spatial-val --visualize
    jobs.append(dict(kind='script', return_states=False, config=dict(
        _psp_val_config(root / 'psp val' / 'two', sub), distributed=True)))

    def make_psp_val():
        one = _meters(_run_one(_psp_val_config(root / 'psp val' / 'one',
                                               sub)))
        one_pngs = base._visual_pngs(root / 'psp val' / 'one')

        def check(ranks):
            _check_scores(ranks, one)
            base._check_pngs(base._visual_pngs(root / 'psp val' / 'two'),
                             one_pngs)
            assert one_pngs and all(px.shape[:2] == (64, 64)
                                    for _, px in one_pngs.values())
        return check
    checks['psp val'] = make_psp_val
    return jobs, checks


# ---------------------------------------------------------------------------
# the runs, made once
# ---------------------------------------------------------------------------

def _verdicts(root):
    """Every check of the file, its failures by name. One process's
    scripts run here while the two ranks run theirs; then one process's
    step runs, each checked as it ends. Final states go through files, a
    run at a time (PSPNet's are 160 MB a model): the ranks check theirs
    against rank 0's, which writes them."""
    masks = _masks()
    runs = {name: _job(name) for name in STEP_RUNS}
    script_jobs, script_checks = _script_jobs(root)
    for sub in ('1x2', '2x2'):
        (root / 'states' / sub).mkdir(parents=True)
    steps = dict(kind='steps', n_spatial=2, steps=STEPS,
                 iters_per_epoch=ITERS_PER_EPOCH)
    layers = dict(kind='layers', cases=list(worker.MODEL_LAYER_CASES),
                  masks=masks)
    started = base._start(dict(kind='many', jobs=[
        layers, dict(steps, runs=runs, states_dir=str(
            root / 'states' / '1x2'))] + script_jobs), root / 'two', 2)
    checks = {name: make() for name, make in script_checks.items()}
    two = base._finish(started, TIMEOUT)
    four = base._spawn(dict(steps, runs={name: runs[name]
                                         for name in GRID_RUNS},
                            states_dir=str(root / 'states' / '2x2')),
                       root / 'four', 4, TIMEOUT)
    verdicts = {'layer {0}-{1}'.format(*case): failures for case, failures
                in _layer_verdicts([r[0] for r in two], masks).items()}
    step_ranks = [r[1] for r in two]
    for name, run in runs.items():
        one, final = _one_process(run)
        for tag, grid, ranks in (('1x2', (1, 2), step_ranks),
                                 ('2x2', (2, 2), four)):
            if tag == '2x2' and name not in GRID_RUNS:
                continue
            try:
                view = _rank_states(ranks, name,
                                    root / 'states' / tag / (name + '.pt'))
            except AssertionError as exc:
                view, failures = None, [str(exc)]
            else:
                failures = base._failures(
                    base._check_against_one_process, view, name, one,
                    final, grid, _spec(name))
            verdicts[tag + ' ' + name] = failures
            if tag == '1x2' and name in JAX_RUNS:
                verdicts['jax ' + name] = failures if view is None else \
                    base._failures(base._check_against_jax, view, run, name)
            del view
        del final
    verdicts['psp gct blurs'] = base._failures(base._check_gct_blurs,
                                               step_ranks, 'psp_gct')
    for i, (name, check) in enumerate(checks.items()):
        verdicts[name] = base._failures(check, [r[2 + i] for r in two])
    for sub in os.listdir(str(root)):  # states, checkpoints and PNGs
        shutil.rmtree(str(root / sub), ignore_errors=True)
    return verdicts


def _rank_states(ranks, name, path):
    """The ranks' results of run ``name`` with the final states that rank 0
    wrote to ``path`` (removed once read), after each rank found its own
    equal to them."""
    for rank, result in enumerate(ranks):
        assert result[name]['equal_to_rank0'], (name, rank)
    states = torch.load(str(path), weights_only=False)
    os.remove(str(path))
    return [{name: dict(result[name], states=states)} for result in ranks]


@pytest.fixture(scope='module')
def verdicts(tmp_path_factory):
    return base._shared(tmp_path_factory, 'spatial_models', _verdicts)


@pytest.mark.parametrize('case', worker.MODEL_LAYER_CASES,
                         ids=['{0}-{1}'.format(*c)
                              for c in worker.MODEL_LAYER_CASES])
def test_model_layer_on_two_ranks_matches_one_process(case, verdicts):
    key = 'layer {0}-{1}'.format(*case)
    assert not verdicts[key], verdicts[key]


@pytest.mark.parametrize('name', sorted(STEP_RUNS))
def test_spatial_train_on_two_ranks_matches_one_process(name, verdicts):
    assert not verdicts['1x2 ' + name], verdicts['1x2 ' + name]


def test_spatial_train_cct_on_a_2x2_grid_matches_one_process(verdicts):
    """Each data coordinate draws its decoders' noise as its part of the
    global draw (its samples and rows)."""
    assert not verdicts['2x2 psp_cct'], verdicts['2x2 psp_cct']


@pytest.mark.parametrize('name', JAX_RUNS)
def test_spatial_train_matches_jax_gspmd(name, verdicts):
    assert not verdicts['jax ' + name], verdicts['jax ' + name]


def test_pspnet_gct_blurs_six_strips_a_step_on_each_rank(verdicts):
    assert not verdicts['psp gct blurs'], verdicts['psp gct blurs']


@pytest.mark.parametrize('name', ['psp script', 'sreg script'])
def test_spatial_train_script_trains_like_one_process(name, verdicts):
    assert not verdicts[name], verdicts[name]


def test_sreg_spatial_val_scores_only_real_pixels(verdicts):
    """``--validation --spatial-val`` of the ``sreg`` script at 36 px on
    two ranks (the images padded to 64, H split 32/32): exactly ``6 * 36 *
    36`` valid pixels, the scores one process's."""
    assert not verdicts['sreg val'], verdicts['sreg val']


def test_pspnet_spatial_val_visualize_matches_one_process(verdicts):
    assert not verdicts['psp val'], verdicts['psp val']


def test_one_rank_grid_is_the_plain_pspnet_and_unet():
    """Inside ``sharded`` on a grid of one rank every layer is the plain
    one: PSPNet and ``unet_lite`` in eval mode equal their forwards outside
    the context."""
    from pixelssl_tpu_torch.models.pspnet import PSPNet
    from pixelssl_tpu_torch.parallel import spatial
    from pixelssl_tpu_torch.tasks.sreg.model import UNetLite
    torch.manual_seed(0)
    x = torch.from_numpy(worker.model_input(33, 40)).permute(0, 3, 1, 2)
    for net in (PSPNet(backbone='resnet10', num_classes=NUM_CLASSES),
                UNetLite(base=8)):
        net.init_weights(torch.Generator().manual_seed(0))
        net.eval()
        with torch.no_grad():
            plain = net(x)[0]
            with spatial.sharded(parallel.make_mesh_2d(1), 33):
                rows = net(x)[0]
        np.testing.assert_allclose(rows.numpy(), plain.numpy(), atol=1e-6)

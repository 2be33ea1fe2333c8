"""S4L, self-supervised semi-supervised learning (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_s4l.py``; reference
pixelssl/ssl_algorithm/ssl_s4l.py).

    Zhai et al., "S4L: Self-Supervised Semi-Supervised Learning", ICCV'19
    (the four-angle rotation pretext, for pixel tasks).

* the batch doubles inside the step: each sample gets a copy rotated by an
  angle drawn from {90, 180, 270} degrees, the input and the dense GT
  together, laid out as [originals ++ rotated]; the rotation GT is
  ``[0] * bs ++ angles`` (ssl_s4l.py:296-350);
* the task model and a ``RotationClassifier`` form one wrapped model whose
  resulter gains a ``rotation`` key from ``ssls4l_rc_inp``; both see the
  doubled batch in one forward, BN included. The head joins the task
  model's optimizer at 1x lr (ssl_s4l.py:403-438);
* losses: the task loss on the unrotated labeled rows, plus
  ``--rotated-sup-scale`` times it on the rotated labeled rows, plus
  ``--rotation-scale`` times the rotation cross-entropy over the whole
  doubled batch; ``rotation_acc`` in percent (ssl_s4l.py:139-173).

Crops must be square: a rotation by 90 degrees swaps H and W.

Under ``--spatial-train`` (``parallel.spatial``) a rotation by 90 or 270
degrees makes columns of the rank's rows: each rank gathers the whole input
and GT maps of its samples (``spatial.whole_rows``, no gradient: 3 channels
and 1), rotates them and keeps its rows. The angles are one draw at the
global batch (``_global_samples``). The rotation logits come out whole on
every rank of a spatial group (``RotationClassifier``), so the rotation
cross-entropy and accuracy count on spatial rank 0 only
(``spatial.whole_share``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.rotation import RotationClassifier
from ..nn.func import split_tensor_tuple
from ..parallel import spatial
from ..task_template.model import group_by_lr_rule
from ..utils import logger
from ..utils.constant import REGRESSION, CLASSIFICATION
from .ssl_base import SSLBase, TaskContext


def add_parser_arguments(parser):
    """Flags match reference ssl_s4l.py:29-30."""
    parser.add_argument('--rotated-sup-scale', type=float, default=-1,
                        help='ssls4l - supervised coefficient on rotated '
                             'labeled data')
    parser.add_argument('--rotation-scale', type=float, default=-1,
                        help='ssls4l - rotation self-supervision coefficient')


def ssl_s4l(args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
            task_func, **ctx_kwargs):
    if not len(model_dict) == len(optimizer_dict) == len(lrer_dict) == len(criterion_dict) == 1:
        logger.log_err('ssl_s4l requires exactly one model/optimizer/lrer/'
                       'criterion')
    if list(model_dict.keys()) != ['model']:
        logger.log_err('ssl_s4l requires component dicts keyed `model`')
    ctx = TaskContext(args, model_dict, optimizer_dict, lrer_dict,
                      criterion_dict, task_func, **ctx_kwargs)
    return SSLS4L(args, ctx)


class WrappedS4LModule(nn.Module):
    """The task model under ``task`` and the rotation head under ``rc``
    (the JAX module's names, so that ``from_jax`` keys line up)."""

    def __init__(self, task, rc):
        super(WrappedS4LModule, self).__init__()
        self.task = task
        self.rc = rc

    def forward(self, inp):
        resulter = self.task(inp)
        if 'ssls4l_rc_inp' not in resulter:
            raise ValueError("ssl_s4l requires resulter key 'ssls4l_rc_inp'")
        resulter = dict(resulter)
        resulter['rotation'] = self.rc(
            resulter['ssls4l_rc_inp'],
            self.task.map_height('ssls4l_rc_inp',
                                 spatial.global_height(inp[0])))
        return resulter

    def param_groups(self):
        """The task model's lr rules over the whole wrapped model: the head
        (``rc.*``) matches none of them and trains at 1x."""
        return group_by_lr_rule(self.named_parameters(), self.task.lr_rule)


def rotate_batch(x, angles, dims):
    """Rotate sample i of ``x`` by ``angles[i]`` in {0, 1, 2, 3}, over the
    spatial ``dims`` (a1, a2), with the JAX package's recipes
    (ssl_s4l.py:79-91): 1 is swap then flip a2, 2 is flip a2 then flip a1,
    3 is swap then flip a1. NCHW images take dims (2, 3), [N,H,W] labels
    (1, 2); H must equal W."""
    a1, a2 = dims
    swapped = x.transpose(a1, a2)
    stacked = torch.stack([x, swapped.flip(a2), x.flip(a2).flip(a1),
                           swapped.flip(a1)])
    return stacked[angles, torch.arange(x.shape[0], device=x.device)]


def rotate_rows(x, angles, h_dim):
    """``rotate_batch`` of ``x`` over axes (``h_dim``, ``h_dim`` + 1). Inside
    a spatial context ``x`` holds this rank's rows of square maps: their
    whole maps are gathered (``spatial.whole_rows``) and rotated, and this
    rank's rows of the result are kept."""
    out = rotate_batch(spatial.whole_rows(x, h_dim), angles,
                       (h_dim, h_dim + 1))
    return spatial.own_rows(out, spatial.global_height(x, h_dim), h_dim)


class SSLS4L(SSLBase):
    NAME = 'ssl_s4l'
    # the rotation pretext is task-agnostic: the dense GT rotates with the
    # input and the task criterion gives the supervised terms
    SUPPORTED_TASK_TYPES = [REGRESSION, CLASSIFICATION]

    def __init__(self, args, ctx):
        super(SSLS4L, self).__init__(args, ctx)
        if args.rotation_scale < 0:
            logger.log_err('ssl_s4l requires --rotation-scale >= 0')
        if args.rotated_sup_scale < 0:
            logger.log_err('ssl_s4l requires --rotated-sup-scale >= 0')
        self.criterion = ctx.criterions['model']
        opt = ctx.optimizers['model']
        self.lr_schedule = ctx.lrers['model'].make(
            opt.base_lr, ctx.iters_per_epoch, args.epochs)

    def _build_modules(self, generator):
        args = self.args
        task = self.ctx.models['model'](args)
        task.init_weights(generator)
        rc = RotationClassifier(int(self.ctx.task_func.ssls4l_rc_in_channels()),
                                bf16=getattr(args, 'bf16', True))
        rc.init_weights(generator)
        self.model = WrappedS4LModule(task, rc)
        return {'model': self.model}

    def _build_optimizers(self):
        self.opt = self.ctx.optimizers['model'].make(self.model.param_groups())
        return {'opt': self.opt}

    def _draw_angles(self, n):
        """``n`` angles in {1, 2, 3} from this step's generator."""
        generator = self._step_rng(self.state.step)
        return torch.randint(1, 4, (n,), generator=generator,
                             device=self.device)

    def _double_batch(self, inp, gt):
        """[originals ++ rotated] inputs and GT, and the rotation GT."""
        angles = self._global_samples(self._draw_angles)
        new_inp = tuple(torch.cat([i, rotate_rows(i, angles, 2)])
                        for i in inp)
        new_gt = tuple(torch.cat([g, rotate_rows(g, angles, g.dim() - 2)])
                       for g in gt)
        rotation_gt = torch.cat([torch.zeros_like(angles), angles])
        return new_inp, new_gt, rotation_gt

    def _step_fn(self, batch):
        args = self.args
        lbs = self.ctx.lbs
        bs = lbs + (self.ctx.ubs or 0)
        inp, gt, rotation_gt = self._double_batch(tuple(batch['inp']),
                                                  tuple(batch['gt']))

        resulter = self.model(inp)
        pred = resulter['pred']
        pred_rotation = resulter['rotation']
        unrot = self._global_mean(self.criterion(
            split_tensor_tuple(pred, 0, lbs), split_tensor_tuple(gt, 0, lbs),
            split_tensor_tuple(inp, 0, lbs)))
        rot = args.rotated_sup_scale * self._global_mean(self.criterion(
            split_tensor_tuple(pred, bs, bs + lbs),
            split_tensor_tuple(gt, bs, bs + lbs),
            split_tensor_tuple(inp, bs, bs + lbs)))
        rotation_loss = args.rotation_scale * self._global_mean(
            spatial.whole_share(F.cross_entropy(pred_rotation, rotation_gt,
                                                reduction='none')))
        with torch.no_grad():
            rotation_acc = self._global_mean(spatial.whole_share(
                (pred_rotation.argmax(dim=1) == rotation_gt).float())) * 100.0

        lr = self._set_lr(self.opt, self.lr_schedule)
        self._apply_updates(self.opt, unrot + rot + rotation_loss,
                            self.model.parameters())
        return {'unrotated_task_loss': unrot.detach(),
                'rotated_task_loss': rot.detach(),
                'rotation_loss': rotation_loss.detach(),
                'rotation_acc': rotation_acc,
                'lr': lr}

    def _eval_fn(self, batch):
        """The task model alone: the rotation head's output is not
        scored."""
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        resulter = self.model.task(inp)
        return {self.NAME: (resulter['activated_pred'],
                            self.criterion(resulter['pred'], gt, inp))}

"""AdvSSL, adversarial semi-supervised learning (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_adv.py``; reference
pixelssl/ssl_algorithm/ssl_adv.py).

    Hung et al., "Adversarial Learning for Semi-supervised Semantic
    Segmentation", BMVC'18.

One step has two parts (JAX ``_step_fn``, ssl_adv.py:123-239):

* step 1 trains the task model with the FC discriminator (D) fixed: the
  task loss on the labeled slice, plus the adversarial terms that push D's
  confidence map towards "real" on the labeled rows (ignore pixels masked,
  with ``--adv-for-labeled``) and on the unlabeled rows. D's parameters
  gather no gradient;
* step 2 trains D on the detached activated prediction of step 1's
  forward, taken before the task model's update (no second task forward):
  fake = the labeled rows, or the whole batch with
  ``--unlabeled-for-discriminator``; real = the one-hot GT of the labeled
  rows; ``d_loss = (fake + real) / 2``, each term times
  ``--discriminator-scale``.

D has its own Adam (β 0.9, 0.99, eps 1e-8, no weight decay;
``nn.optimizer.Adam``, torch's Adam with a step a CUDA graph can capture)
and its own poly schedule, ``discriminator_lr * (1 - k / max_iters) ** power`` on its
update count k (ssl_adv.py:93-113); its lr scales with the ranks of the
data axis (``ctx.n_dev``).

Under ``--spatial-train`` D runs row-sharded on the rank's rows of the
prediction and the one-hot GT (``models/discriminator.py``), its BCE a
share, and the masks of the ignore pixels come from the rank's rows of the
GT.
"""

import torch

from ..models.discriminator import FCDiscriminator, fc_discriminator_criterion
from ..nn.func import split_tensor_tuple
from ..nn.optimizer import Adam
from ..utils import cmd, logger
from ..utils.constant import REGRESSION, CLASSIFICATION
from .ssl_base import SSLBase, TaskContext, _first, save_gray_map


def add_parser_arguments(parser):
    """Flags match reference ssl_adv.py:28-38."""
    parser.add_argument('--adv-for-labeled', type=cmd.str2bool, default=False,
                        help='ssladv - adversarial constraint on labeled data')
    parser.add_argument('--labeled-adv-scale', type=float, default=-1,
                        help='ssladv - labeled adversarial coefficient')
    parser.add_argument('--unlabeled-adv-scale', type=float, default=-1,
                        help='ssladv - unlabeled adversarial coefficient')
    parser.add_argument('--discriminator-lr', type=float, default=1e-4,
                        help='ssladv - initial lr of the FC discriminator')
    parser.add_argument('--discriminator-power', type=float, default=0.9,
                        help='ssladv - PolynomialLR power for the '
                             'discriminator')
    parser.add_argument('--unlabeled-for-discriminator', type=cmd.str2bool,
                        default=False,
                        help='ssladv - train D with unlabeled data too')
    parser.add_argument('--discriminator-scale', type=float, default=1.0,
                        help='ssladv - D loss coefficient')


def ssl_adv(args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
            task_func, **ctx_kwargs):
    if not len(model_dict) == len(optimizer_dict) == len(lrer_dict) == len(criterion_dict) == 1:
        logger.log_err('ssl_adv requires exactly one model/optimizer/lrer/'
                       'criterion')
    if list(model_dict.keys()) != ['model']:
        logger.log_err('ssl_adv requires component dicts keyed `model`')
    ctx = TaskContext(args, model_dict, optimizer_dict, lrer_dict,
                      criterion_dict, task_func, **ctx_kwargs)
    return SSLADV(args, ctx)


class SSLADV(SSLBase):
    NAME = 'ssl_adv'
    SUPPORTED_TASK_TYPES = [REGRESSION, CLASSIFICATION]

    def __init__(self, args, ctx):
        super(SSLADV, self).__init__(args, ctx)
        # hyperparameter checks (reference ssl_adv.py:74-86)
        if args.adv_for_labeled and args.labeled_adv_scale < 0:
            logger.log_err('ssl_adv requires --labeled-adv-scale >= 0 when '
                           '--adv-for-labeled is set')
        if (ctx.ubs or 0) > 0 and args.unlabeled_adv_scale < 0:
            logger.log_err('ssl_adv requires --unlabeled-adv-scale >= 0 when '
                           'unlabeled data is used')
        self.criterion = ctx.criterions['model']
        opt = ctx.optimizers['model']
        self.lr_schedule = ctx.lrers['model'].make(
            opt.base_lr, ctx.iters_per_epoch, args.epochs)

        d_lr = args.discriminator_lr * ctx.n_dev  # reference ssl_adv.py:72
        max_iters = max(1, ctx.iters_per_epoch * args.epochs)
        self.d_lr_schedule = lambda step: d_lr * min(
            max(1.0 - step / max_iters, 0.0), 1.0) ** args.discriminator_power

    def _build_modules(self, generator):
        args = self.args
        self.model = self.ctx.models['model'](args)
        self.model.init_weights(generator)
        self.d_model = FCDiscriminator(
            int(self.ctx.task_func.ssladv_fcd_in_channels()),
            bf16=getattr(args, 'bf16', True))
        self.d_model.init_weights(generator)
        return {'model': self.model, 'd_model': self.d_model}

    def _build_optimizers(self):
        self.opt = self.ctx.optimizers['model'].make(self.model.param_groups())
        self.d_opt = Adam(self.d_model.parameters(),
                          lr=self.d_lr_schedule(0), betas=(0.9, 0.99),
                          eps=1e-8)
        return {'opt': self.opt, 'd_opt': self.d_opt}

    def _fcd_loss(self, cmap, task_gt, is_real):
        """D's BCE on ``cmap`` against real or fake, ignore pixels of
        ``task_gt`` masked: [N]."""
        cmap, target = self.ctx.task_func.ssladv_preprocess_fcd_criterion(
            cmap, task_gt, is_real)
        return fc_discriminator_criterion(cmap, target)

    def _step_fn(self, batch):
        args = self.args
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        lbs = self.ctx.lbs
        ubs = self.ctx.ubs or 0
        l_gt = split_tensor_tuple(gt, 0, lbs)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)

        # step 1: the task model, D fixed
        resulter = self.model(inp)
        act = resulter['activated_pred'][0]
        cmap = self.d_model(act)
        task_loss = self._global_mean(self.criterion(
            split_tensor_tuple(resulter['pred'], 0, lbs), l_gt,
            split_tensor_tuple(inp, 0, lbs)))
        labeled_adv = unlabeled_adv = zero
        if args.adv_for_labeled:
            labeled_adv = args.labeled_adv_scale * self._global_mean(
                self._fcd_loss(cmap[:lbs], l_gt[0], True))
        if ubs > 0:
            unlabeled_adv = args.unlabeled_adv_scale * self._global_mean(
                self._fcd_loss(cmap[lbs:], None, True))
        lr = self._set_lr(self.opt, self.lr_schedule)
        self._apply_updates(self.opt, task_loss + labeled_adv + unlabeled_adv,
                            self.model.parameters())

        # step 2: D on step 1's detached prediction and the one-hot GT. D
        # has no normalisation, so one forward over [fake ++ real] gives
        # each row the map it would get alone; the JAX step pads the real
        # rows to the full batch only to get round a TPU compiler fault
        # (ssl_adv.py:185-194), with the same loss.
        n_fake = lbs + ubs if args.unlabeled_for_discriminator else lbs
        real = self.ctx.task_func.ssladv_convert_task_gt_to_fcd_input(l_gt[0])
        d_cmap = self.d_model(torch.cat([act.detach()[:n_fake],
                                         real.to(act.dtype)]))
        fake_losses = self._fcd_loss(d_cmap[:lbs], l_gt[0], False)
        if n_fake > lbs:
            fake_losses = torch.cat([fake_losses, self._fcd_loss(
                d_cmap[lbs:n_fake], None, False)])
        fake_d_loss = args.discriminator_scale * self._global_mean(
            fake_losses)
        real_d_loss = args.discriminator_scale * self._global_mean(
            self._fcd_loss(d_cmap[n_fake:], l_gt[0], True))
        self._set_lr(self.d_opt, self.d_lr_schedule)
        self._apply_updates(self.d_opt, (fake_d_loss + real_d_loss) / 2.0,
                            self.d_model.parameters())

        return {'task_loss': task_loss.detach(),
                'labeled_adv_loss': labeled_adv.detach(),
                'unlabeled_adv_loss': unlabeled_adv.detach(),
                'fake_d_loss': fake_d_loss.detach(),
                'real_d_loss': real_d_loss.detach(),
                'lr': lr}

    def _eval_fn(self, batch):
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        resulter = self.model(inp)
        return {self.NAME: (resulter['activated_pred'],
                            self.criterion(resulter['pred'], gt, inp))}

    def _debug_visualize(self, batch, out_path):
        """D's confidence maps of the first labeled and the first unlabeled
        sample of this rank's batch (JAX ssl_adv.py:249-270, reference
        ssl_adv.py:393-408); under ``--spatial-train`` through the
        row-sharded D, the rows gathered."""
        act = self.model(tuple(batch['inp']))['activated_pred'][0]
        cmap = torch.sigmoid(self.d_model(act).float())
        self._write(save_gray_map, _first((cmap,))[0],
                    out_path + '_labeled-cmap.png')
        if (self.ctx.ubs or 0) > 0:
            self._write(save_gray_map, _first((cmap[self.ctx.lbs:],))[0],
                        out_path + '_unlabeled-cmap.png')

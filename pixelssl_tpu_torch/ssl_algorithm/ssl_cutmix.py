"""CutMix consistency (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_cutmix.py``; reference
pixelssl/ssl_algorithm/ssl_cutmix.py).

    French et al., "Semi-supervised semantic segmentation needs strong,
    varied perturbations", BMVC'20.

* a student and an EMA teacher (decay ``min(1 - 1/(step+1),
  ema_decay)``, 0.99 by default; ``--bf16-ema`` as in MT);
* the unlabeled rows split into halves, mixed as ``mask * u1 + (1 - mask)
  * u2`` with one inverted in-bounds box mask a pair (``ops/boxmask.py``;
  ssl_cutmix.py:419-430);
* the teacher runs in train mode without gradients on the unmixed
  unlabeled rows, so its BN running statistics move; its activated
  predictions, mixed with the same mask, are the pseudo-GT
  (ssl_cutmix.py:189-203). The EMA covers its parameters only;
* confidence: the share of pixels whose largest class probability
  exceeds ``--cons-threshold``, a scalar on the MSE consistency
  (ssl_cutmix.py:198-215), ramped up as in MT;
* the student runs two forwards, the labeled rows first and the mixed rows
  second, its BN statistics moving with each in turn (ssl_cutmix.py:151-166);
* the unlabeled batch must be even and at least 2 (ssl_cutmix.py:82-85).

Under ``--spatial-train`` (``parallel.spatial``) sample i pairs with sample
i + U/2 of the global unlabeled block, as in the JAX package's GSPMD step:
each data coordinate holds its share of each half (``spatial.PAIRED``),
the box masks are one draw at the global pairs and (H, W) of which the
rank keeps its pairs and rows, the MSE is the rank's share
(``spatial.sample_mean``) and the confidence the pixel mean over the grid
(``spatial.pixel_mean``).
"""

import copy

import torch

from ..nn.func import split_tensor_tuple
from ..ops.boxmask import box_masks
from ..parallel import spatial
from ..utils import cmd, logger
from ..utils.constant import CLASSIFICATION
from .ssl_base import (SSLBase, TaskContext, forward_with_float32_params,
                       maybe_bf16)


def add_parser_arguments(parser):
    """Flags match reference ssl_cutmix.py:37-45."""
    parser.add_argument('--cons-type', type=str, default='mse',
                        choices=['mse'], help='sslcutmix - consistency type')
    parser.add_argument('--cons-scale', type=float, default=-1,
                        help='sslcutmix - consistency coefficient')
    parser.add_argument('--cons-rampup-epochs', type=int, default=-1,
                        help='sslcutmix - consistency ramp-up epochs')
    parser.add_argument('--cons-threshold', type=float, default=-1,
                        help='sslcutmix - confidence threshold')
    parser.add_argument('--ema-decay', type=float, default=0.99,
                        help='sslcutmix - teacher EMA decay')
    parser.add_argument('--bf16-ema', type=cmd.str2bool, default=False,
                        help='sslcutmix - store the EMA teacher in bf16')
    parser.add_argument('--mask-prop-range', type=cmd.str2floatlist,
                        default='(0.5, 0.5)',
                        help='sslcutmix - mixing ratio range')


def ssl_cutmix(args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
               task_func, **ctx_kwargs):
    if not len(model_dict) == len(optimizer_dict) == len(lrer_dict) == len(criterion_dict) == 1:
        logger.log_err('ssl_cutmix requires exactly one model/optimizer/'
                       'lrer/criterion')
    if list(model_dict.keys()) != ['model']:
        logger.log_err('ssl_cutmix requires component dicts keyed `model`')
    ctx = TaskContext(args, model_dict, optimizer_dict, lrer_dict,
                      criterion_dict, task_func, **ctx_kwargs)
    return SSLCUTMIX(args, ctx)


class SSLCUTMIX(SSLBase):
    NAME = 'ssl_cutmix'
    SUPPORTED_TASK_TYPES = [CLASSIFICATION]

    def __init__(self, args, ctx):
        super(SSLCUTMIX, self).__init__(args, ctx)
        ubs = ctx.ubs or 0
        if ubs > 0:
            if ubs < 2 or ubs % 2 != 0:
                logger.log_err('ssl_cutmix requires an even unlabeled batch '
                               'size >= 2 (got {0})'.format(ubs))
            if args.cons_scale < 0:
                logger.log_err('ssl_cutmix requires --cons-scale >= 0')
            if args.cons_rampup_epochs < 0:
                logger.log_err('ssl_cutmix requires --cons-rampup-epochs >= 0')
            if not 0 <= args.cons_threshold <= 1:
                logger.log_err('ssl_cutmix requires 0 <= --cons-threshold '
                               '<= 1')
        self.criterion = ctx.criterions['model']
        opt = ctx.optimizers['model']
        self.lr_schedule = ctx.lrers['model'].make(
            opt.base_lr, ctx.iters_per_epoch, args.epochs)
        self.bf16_ema = bool(getattr(args, 'bf16_ema', False))

    def _build_modules(self, generator):
        self.model = self.ctx.models['model'](self.args)
        self.model.init_weights(generator)
        self.teacher = maybe_bf16(copy.deepcopy(self.model), self.bf16_ema)
        self.teacher.requires_grad_(False)
        return {'model': self.model, 'teacher': self.teacher}

    def _build_optimizers(self):
        self.opt = self.ctx.optimizers['model'].make(self.model.param_groups())
        return {'opt': self.opt}

    def _teacher_forward(self, inp):
        return forward_with_float32_params(self.teacher, inp, self.bf16_ema)

    def _draw_masks(self, n, shape):
        """``n`` box masks [n,1,H,W] from this step's generator."""
        return box_masks(self._step_rng(self.state.step), n, shape,
                         self.args.mask_prop_range)

    def _pair_masks(self, half, x):
        """The masks of this rank's ``half`` pairs of ``x`` (its unlabeled
        rows): under ``--spatial-train`` those of its data coordinate and
        its rows, of one draw at the global pairs and (H, W)."""
        if not self.mesh.spatial:
            return self._draw_masks(half, tuple(x.shape[2:]))
        h = spatial.active().height
        d = self.mesh.data_rank
        full = self._draw_masks(half * self.mesh.data_size, (h, x.shape[3]))
        r0, r1 = spatial.local_rows(h, self.mesh)
        return full[d * half:(d + 1) * half, :, r0:r1]

    def _step_fn(self, batch):
        args = self.args
        ctx = self.ctx
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        lbs = ctx.lbs
        ubs = ctx.ubs or 0
        l_inp = split_tensor_tuple(inp, 0, lbs)
        l_gt = split_tensor_tuple(gt, 0, lbs)

        if ubs > 0:
            u_inp = split_tensor_tuple(inp, lbs, lbs + ubs)
            half = ubs // 2
            mask = self._pair_masks(half, u_inp[0])

            def mix(x):
                return mask * x[:half] + (1.0 - mask) * x[half:]

            mix_u_inp = tuple(mix(u) for u in u_inp)
            # the teacher: train mode (its BN statistics move), no gradient
            with torch.no_grad():
                u_t_act = self._teacher_forward(u_inp)['activated_pred']
                mix_t_act = [mix(a) for a in u_t_act]
                confidences = [spatial.pixel_mean(
                    a.amax(dim=1) > args.cons_threshold, self.mesh)
                    for a in mix_t_act]

        # the labeled rows first, then the mixed rows: two forwards whose
        # BN statistics move in turn
        l_resulter = self.model(l_inp)
        task_loss = self._global_mean(
            self.criterion(l_resulter['pred'], l_gt, l_inp))
        cons_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if ubs > 0:
            mix_s_act = self.model(mix_u_inp)['activated_pred']
            for s_act, t_act, conf in zip(mix_s_act, mix_t_act, confidences):
                mse = self._global_mean(spatial.sample_mean(torch.square(
                    s_act.float() - t_act.float())))
                cons_loss = cons_loss + mse * conf
            cons_loss = self._rampup(args.cons_rampup_epochs,
                                     args.cons_scale) * cons_loss

        lr = self._set_lr(self.opt, self.lr_schedule)
        self._apply_updates(self.opt, task_loss + cons_loss,
                            self.model.parameters())
        self._ema_update(self.teacher, self.model, args.ema_decay)

        return {'task_loss': task_loss.detach(),
                'cons_loss': cons_loss.detach(),
                'lr': lr}

    def _eval_fn(self, batch):
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        out = {}
        for model_id, resulter in (('student', self.model(inp)),
                                   ('teacher', self._teacher_forward(inp))):
            out[model_id] = (resulter['activated_pred'],
                             self.criterion(resulter['pred'], gt, inp))
        return out

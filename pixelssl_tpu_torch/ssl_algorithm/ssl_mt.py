"""Mean Teacher (counterpart of ``pixelssl_tpu/ssl_algorithm/ssl_mt.py``;
reference pixelssl/ssl_algorithm/ssl_mt.py).

    Tarvainen & Valpola, "Mean teachers are better role models", NeurIPS'17.

* a student and an EMA teacher of the same architecture; only the student
  has an optimizer (reference ssl_mt.py:95-103);
* Gaussian input noise, drawn apart for student and teacher, train only
  (ssl_mt.py:120,337-357);
* task loss on the labeled slice (ssl_mt.py:154-161);
* consistency = MSE between the raw student and teacher predictions, the
  teacher's detached, on the whole batch with ``--cons-for-labeled`` and on
  the unlabeled slice otherwise, ramped up over ``--cons-rampup-epochs``
  (ssl_mt.py:179-188,140-142);
* after every optimizer step the teacher's parameters move to the
  student's with decay ``min(1 - 1/(step+1), ema_decay)``
  (ssl_mt.py:196,359-363). Its BN running statistics are not averaged: they
  come from its own train-mode forward, which runs without gradients
  before the student's;
* validation scores both models, ids ``student`` and ``teacher``
  (ssl_mt.py:226-290).

With ``--bf16-ema`` the teacher's parameters are stored in bf16 and its
forward runs on float32 copies of them. Under ``--spatial-train`` the
noise is one draw at the global batch's shape, normalised by each
sample's extrema over its rows on every rank, and the consistency is each
rank's share of the per-sample MSE.
"""

import copy

import torch

from ..nn.func import split_tensor_tuple
from ..nn.module.gaussian_noise import gaussian_noise
from ..utils import cmd, logger
from ..parallel import spatial
from ..utils.constant import REGRESSION, CLASSIFICATION
from .ssl_base import (SSLBase, TaskContext, forward_with_float32_params,
                       maybe_bf16)


def add_parser_arguments(parser):
    """Flags match reference ssl_mt.py:30-38 and the JAX package."""
    parser.add_argument('--cons-for-labeled', type=cmd.str2bool, default=True,
                        help='sslmt - consistency on labeled data too')
    parser.add_argument('--cons-scale', type=float, default=-1,
                        help='sslmt - consistency coefficient')
    parser.add_argument('--cons-rampup-epochs', type=int, default=-1,
                        help='sslmt - consistency ramp-up epochs')
    parser.add_argument('--ema-decay', type=float, default=0.999,
                        help='sslmt - teacher EMA decay')
    parser.add_argument('--bf16-ema', type=cmd.str2bool, default=False,
                        help='sslmt - store the EMA teacher in bf16. Updates '
                             'below the bf16 half-ULP are rounded away, so '
                             'the teacher stops tracking near convergence')
    parser.add_argument('--gaussian-noise-std', type=float, default=None,
                        help='sslmt - std of input gaussian noise (None '
                             'disables)')


def ssl_mt(args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
           task_func, **ctx_kwargs):
    if not len(model_dict) == len(optimizer_dict) == len(lrer_dict) == len(criterion_dict) == 1:
        logger.log_err('ssl_mt requires exactly one model/optimizer/lrer/'
                       'criterion')
    if list(model_dict.keys()) != ['model']:
        logger.log_err('ssl_mt requires component dicts keyed `model`')
    ctx = TaskContext(args, model_dict, optimizer_dict, lrer_dict,
                      criterion_dict, task_func, **ctx_kwargs)
    return SSLMT(args, ctx)


class SSLMT(SSLBase):
    NAME = 'ssl_mt'
    SUPPORTED_TASK_TYPES = [REGRESSION, CLASSIFICATION]

    def __init__(self, args, ctx):
        super(SSLMT, self).__init__(args, ctx)
        # hyperparameter checks (reference ssl_mt.py:77-89)
        if args.cons_for_labeled or (ctx.ubs or 0) > 0:
            if args.cons_scale < 0:
                logger.log_err('ssl_mt requires --cons-scale >= 0')
            if args.cons_rampup_epochs < 0:
                logger.log_err('ssl_mt requires --cons-rampup-epochs >= 0')
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

    def _noised(self, inp, salt):
        """Noise the first input element (reference ssl_mt.py:337-357);
        ``salt`` 0 draws the student's noise, 1 the teacher's."""
        std = self.args.gaussian_noise_std
        if std is None or std <= 0:
            return inp
        generator = self._step_rng(self.state.step, salt)
        return (gaussian_noise(inp[0], std, generator, self._global_draw),) \
            + tuple(inp[1:])

    def _step_fn(self, batch):
        args = self.args
        ctx = self.ctx
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        lbs = ctx.lbs
        s_inp = self._noised(inp, 0)
        t_inp = self._noised(inp, 1)

        # teacher: train mode (its BN statistics move), no gradient
        with torch.no_grad():
            t_pred = self._teacher_forward(t_inp)['pred']

        s_pred = self.model(s_inp)['pred']
        task_loss = self._global_mean(self.criterion(
            split_tensor_tuple(s_pred, 0, lbs),
            split_tensor_tuple(gt, 0, lbs),
            split_tensor_tuple(s_inp, 0, lbs)))

        # consistency on the raw predictions (reference ssl_mt.py:179-188)
        if args.cons_for_labeled:
            diff = s_pred[0] - t_pred[0]
        elif (ctx.ubs or 0) > 0:
            diff = s_pred[0][lbs:] - t_pred[0][lbs:]
        else:
            diff = None
        if diff is None:
            cons_loss = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
        else:
            cons_mse = self._global_mean(spatial.sample_mean(
                torch.square(diff.float())))
            cons_loss = self._rampup(args.cons_rampup_epochs,
                                     args.cons_scale) * cons_mse

        lr = self._set_lr(self.opt, self.lr_schedule)
        self._apply_updates(self.opt, task_loss + cons_loss,
                            self.model.parameters())

        # the teacher's loss on the labeled slice, logged only
        with torch.no_grad():
            t_task_loss = self._global_mean(self.criterion(
                split_tensor_tuple(t_pred, 0, lbs),
                split_tensor_tuple(gt, 0, lbs),
                split_tensor_tuple(t_inp, 0, lbs)))

        self._ema_update(self.teacher, self.model, args.ema_decay)

        return {'s_task_loss': task_loss.detach(),
                'cons_loss': cons_loss.detach(),
                't_task_loss': t_task_loss,
                'lr': lr}

    def _eval_fn(self, batch):
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        out = {}
        for model_id, resulter in (('student', self.model(inp)),
                                   ('teacher', self._teacher_forward(inp))):
            out[model_id] = (resulter['activated_pred'],
                             self.criterion(resulter['pred'], gt, inp))
        return out

"""GCT, Guided Collaborative Training (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_gct.py``; reference
pixelssl/ssl_algorithm/ssl_gct.py).

    Ke et al., "Guided Collaborative Training for Pixel-wise
    Semi-Supervised Learning", ECCV'20.

One step has three phases (reference ssl_gct.py:176-298, JAX
``_step_fn``):

* phase 0, without gradients: both task models forward in train mode (their
  BN statistics update), the flaw detector (FD) forwards on both activated
  predictions (its BN statistics update too), and the flawmap handler and
  the DCGT generator make the dynamic-consistency pseudo-GT and the
  flaw-correction mask;
* phase 1: each task model takes an SGD step on CE + flaw correction +
  ramped dynamic consistency; the FD forwards in the graph but gathers no
  gradient;
* phase 2: the FD takes an Adam(0.9, 0.99) step on the labeled slice,
  against the FDGT pipeline's output. Its two forwards run on scratch
  copies of the FD's BN buffers, so they leave the statistics where phase 1
  left them, as the JAX step does.

The pipeline functions take and return NHWC maps, as the JAX ones do; the
modules are NCHW and the step passes permuted views between them. Every
blur goes through ``ops.blur.gaussian_blur_fused``: six launches a step.
"""

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..models.flaw_detector import FlawDetector, flaw_detector_criterion
from ..nn.func import sigmoid_rampup, split_tensor_tuple
from ..nn.optimizer import set_lr
from ..ops.blur import gaussian_blur_fused as _blur
from ..utils import logger
from ..utils.constant import REGRESSION, CLASSIFICATION
from .ssl_base import SSLBase, TaskContext

MODE_GCT = 'gct'
MODE_FC = 'fc'
MODE_DC = 'dc'


def add_parser_arguments(parser):
    """Flags match reference ssl_gct.py:36-52."""
    parser.add_argument('--ssl-mode', type=str, default=MODE_GCT,
                        choices=[MODE_GCT, MODE_DC, MODE_FC],
                        help='sslgct - constraint selection (gct = dc + fc)')
    parser.add_argument('--fc-ssl-scale', type=float, default=-1.0,
                        help='sslgct - flaw correction coefficient')
    parser.add_argument('--dc-ssl-scale', type=float, default=-1.0,
                        help='sslgct - dynamic consistency coefficient')
    parser.add_argument('--dc-threshold', type=float, default=-1.0,
                        help='sslgct - dynamic consistency threshold')
    parser.add_argument('--dc-rampup-epochs', type=int, default=-1,
                        help='sslgct - dynamic consistency ramp-up epochs')
    parser.add_argument('--fd-lr', type=float, default=1e-4,
                        help='sslgct - initial flaw-detector lr')
    parser.add_argument('--fd-scale', type=float, default=1.0,
                        help='sslgct - flaw-detector loss coefficient')
    parser.add_argument('--mu', type=float, default=-1.0,
                        help='sslgct - FDGT channel average coefficient')
    parser.add_argument('--nu', type=int, default=-1,
                        help='sslgct - FDGT dilate/reblur repeats')


def ssl_gct(args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
            task_func, **ctx_kwargs):
    if not len(model_dict) == len(optimizer_dict) == len(lrer_dict) == len(criterion_dict):
        logger.log_err('ssl_gct component dicts must have equal length')
    if len(model_dict) == 1:
        if list(model_dict.keys()) != ['model']:
            logger.log_err('ssl_gct 1-key component dicts must be keyed `model`')
        keys = ('model', 'model')
    elif len(model_dict) == 2:
        if set(model_dict.keys()) != {'lmodel', 'rmodel'}:
            logger.log_err('ssl_gct 2-key component dicts must be keyed '
                           '(lmodel, rmodel)')
        keys = ('lmodel', 'rmodel')
    else:
        logger.log_err('ssl_gct supports component dicts with 1 or 2 keys')
    ctx = TaskContext(args, model_dict, optimizer_dict, lrer_dict,
                      criterion_dict, task_func, **ctx_kwargs)
    return SSLGCT(args, ctx, keys)


# ---------------------------------------------------------------------------
# pipeline functions (reference ssl_gct.py:624-728), NHWC maps [N,H,W,1]
# ---------------------------------------------------------------------------

def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _odd(k):
    return k + 1 if k % 2 == 0 else k


def _minmax_normalize(x):
    xmax = x.amax(dim=(1, 2, 3), keepdim=True)
    xmin = x.amin(dim=(1, 2, 3), keepdim=True)
    return (x - xmin) / (xmax - xmin + 1e-9), xmin, xmax


def flawmap_handler(flawmap, im_size, clip_threshold=0.1):
    """Reference ssl_gct.py:624-657, in its op order: the min-max
    normalisation uses the minimum and maximum from before the clip."""
    fm = flawmap.detach().float()
    fm = fm * (fm >= 0).float()
    fm = _blur(fm, _odd(int(im_size / 16)))
    fmax = fm.amax(dim=(1, 2, 3), keepdim=True)
    fmin = fm.amin(dim=(1, 2, 3), keepdim=True)
    fm = fm * (fmax > clip_threshold).float()
    return (fm - fmin) / (fmax - fmin + 1e-9)


def dcgt_generator(l_pred, r_pred, l_flawmap, r_flawmap, dc_threshold):
    """Reference ssl_gct.py:660-689: per pixel, the better model's activated
    prediction is the other's pseudo-GT; pixels above the threshold count as
    1.0 before the comparison; the fc mask marks pixels where both are bad."""
    l_bad = l_flawmap > dc_threshold
    r_bad = r_flawmap > dc_threshold
    both_bad = (l_bad & r_bad).float()

    l_h = torch.where(l_bad, torch.ones_like(l_flawmap), l_flawmap)
    r_h = torch.where(r_bad, torch.ones_like(r_flawmap), r_flawmap)

    l_mask = (r_h >= l_h).float()
    r_mask = (l_h >= r_h).float()
    l_dc_gt = l_mask * l_pred + (1.0 - l_mask) * r_pred
    r_dc_gt = r_mask * r_pred + (1.0 - r_mask) * l_pred
    return l_dc_gt, r_dc_gt, both_bad, both_bad


def _dilate3x3(x):
    """3x3 max filter with reflect padding (the edge not repeated), NHWC."""
    y = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode='reflect')
    return _nhwc(F.max_pool2d(y, 3, stride=1))


def fdgt_generator(pred, gt_encoded, im_size, mu, nu):
    """Reference ssl_gct.py:692-728: the flaw detector's ground truth."""
    diff = torch.abs(gt_encoded.float() - pred.detach().float())
    diff = diff.sum(dim=-1, keepdim=True) * mu
    diff = _blur(diff, _odd(int(im_size / 8)))
    for _ in range(int(nu)):
        diff = _blur(_dilate3x3(diff), _odd(int(im_size / 4)))
    out, _, _ = _minmax_normalize(diff)
    return out


class SSLGCT(SSLBase):
    NAME = 'ssl_gct'
    SUPPORTED_TASK_TYPES = [REGRESSION, CLASSIFICATION]

    def __init__(self, args, ctx, keys):
        super(SSLGCT, self).__init__(args, ctx)
        self.l_key, self.r_key = keys

        # hyperparameter validation (reference ssl_gct.py:110-134)
        if (ctx.ubs or 0) > 0:
            if args.ssl_mode in (MODE_GCT, MODE_FC) and args.fc_ssl_scale < 0:
                logger.log_err('ssl_gct requires --fc-ssl-scale >= 0')
            if args.ssl_mode in (MODE_GCT, MODE_DC):
                if args.dc_rampup_epochs < 0:
                    logger.log_err('ssl_gct requires --dc-rampup-epochs >= 0')
                if args.dc_ssl_scale < 0:
                    logger.log_err('ssl_gct requires --dc-ssl-scale >= 0')
                if args.dc_threshold < 0:
                    logger.log_err('ssl_gct requires --dc-threshold >= 0')
                if args.mu < 0:
                    logger.log_err('ssl_gct requires 0 < --mu <= 1')
                if args.nu < 0:
                    logger.log_err('ssl_gct requires --nu > 0')

        self.l_criterion = ctx.criterions[self.l_key]
        self.r_criterion = ctx.criterions[self.r_key]
        l_opt = ctx.optimizers[self.l_key]
        r_opt = ctx.optimizers[self.r_key]
        self.l_lr_schedule = ctx.lrers[self.l_key].make(
            l_opt.base_lr, ctx.iters_per_epoch, args.epochs)
        self.r_lr_schedule = ctx.lrers[self.r_key].make(
            r_opt.base_lr, ctx.iters_per_epoch, args.epochs)

        fd_lr = args.fd_lr * ctx.n_dev  # reference ssl_gct.py:107
        max_iters = max(1, ctx.iters_per_epoch * args.epochs)
        self.fd_lr_schedule = lambda step: fd_lr * min(
            max(1.0 - step / max_iters, 0.0), 1.0) ** 0.9

    def _build_modules(self, generator):
        args = self.args
        self.l_model = self.ctx.models[self.l_key](args)
        self.l_model.init_weights(generator)
        self.r_model = self.ctx.models[self.r_key](args)
        self.r_model.init_weights(generator)
        self.fd_model = FlawDetector(
            int(self.ctx.task_func.sslgct_fd_in_channels()),
            bf16=getattr(args, 'bf16', True))
        self.fd_model.init_weights(generator)
        return {'l_model': self.l_model, 'r_model': self.r_model,
                'fd_model': self.fd_model}

    def _build_optimizers(self):
        self.l_opt = self.ctx.optimizers[self.l_key].make(
            self.l_model.param_groups())
        self.r_opt = self.ctx.optimizers[self.r_key].make(
            self.r_model.param_groups())
        self.fd_opt = torch.optim.Adam(self.fd_model.parameters(),
                                       lr=self.fd_lr_schedule(0),
                                       betas=(0.9, 0.99), eps=1e-8)
        return {'l_opt': self.l_opt, 'r_opt': self.r_opt,
                'fd_opt': self.fd_opt}

    def _step_fn(self, batch):
        args = self.args
        ctx = self.ctx
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        lbs = ctx.lbs
        im_size = inp[0].shape[2]
        step = self.state.step
        dc_rampup = sigmoid_rampup(
            step, ctx.iters_per_epoch * max(args.dc_rampup_epochs, 0))
        metrics = {}

        # phase 0: no-grad pre-forwards; BN statistics update as in train()
        with torch.no_grad():
            l_act0 = self.l_model(inp)['activated_pred'][0]
            r_act0 = self.r_model(inp)['activated_pred'][0]
            l_flawmap0 = self.fd_model(inp, l_act0)
            r_flawmap0 = self.fd_model(inp, r_act0)

        l_dc_gt = r_dc_gt = l_fc_mask = r_fc_mask = None
        if args.ssl_mode in (MODE_GCT, MODE_DC):
            l_handled = flawmap_handler(_nhwc(l_flawmap0), im_size)
            r_handled = flawmap_handler(_nhwc(r_flawmap0), im_size)
            l_dc_gt, r_dc_gt, l_fc_mask, r_fc_mask = dcgt_generator(
                _nhwc(l_act0), _nhwc(r_act0), l_handled, r_handled,
                args.dc_threshold)

        # phase 1: task models; the FD forwards but gathers no gradient
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        for mid, model, opt, criterion, schedule, dc_gt, fc_mask in (
                ('l', self.l_model, self.l_opt, self.l_criterion,
                 self.l_lr_schedule, l_dc_gt, l_fc_mask),
                ('r', self.r_model, self.r_opt, self.r_criterion,
                 self.r_lr_schedule, r_dc_gt, r_fc_mask)):
            resulter = model(inp)
            pred = resulter['pred']
            act = resulter['activated_pred'][0]
            flawmap = _nhwc(self.fd_model(inp, act))

            task_loss = self._global_mean(criterion(
                split_tensor_tuple(pred, 0, lbs),
                split_tensor_tuple(gt, 0, lbs),
                split_tensor_tuple(inp, 0, lbs)))

            fc_loss = dc_loss = zero
            if args.ssl_mode in (MODE_GCT, MODE_FC):
                fc = flaw_detector_criterion(
                    flawmap, torch.zeros_like(flawmap), reduction=False)
                if args.ssl_mode == MODE_GCT:
                    fc = fc_mask * fc
                fc_loss = args.fc_ssl_scale * self._global_mean(
                    fc.mean(dim=(1, 2, 3)))
            if args.ssl_mode in (MODE_GCT, MODE_DC):
                dc = torch.square(_nhwc(act).float() - dc_gt.float()).mean(
                    dim=(1, 2, 3))
                dc_loss = dc_rampup * args.dc_ssl_scale * self._global_mean(dc)

            set_lr(opt, schedule(step))
            self._apply_updates(opt, task_loss + fc_loss + dc_loss,
                                model.parameters())
            metrics[mid + '_task_loss'] = task_loss.detach()
            metrics[mid + '_fc_loss'] = fc_loss.detach()
            metrics[mid + '_dc_loss'] = dc_loss.detach()

        # phase 2: flaw detector on the labeled slice
        gt_enc = ctx.task_func.sslgct_prepare_task_gt_for_fdgt(gt[0][:lbs])
        nu = max(args.nu, 0)
        l_fdgt = fdgt_generator(_nhwc(l_act0[:lbs]), gt_enc, im_size,
                                args.mu, nu)
        r_fdgt = fdgt_generator(_nhwc(r_act0[:lbs]), gt_enc, im_size,
                                args.mu, nu)
        scratch = {name: buf.clone()
                   for name, buf in self.fd_model.named_buffers()}
        fm_l = _nhwc(functional_call(self.fd_model, scratch, (inp, l_act0)))
        fm_r = _nhwc(functional_call(self.fd_model, scratch, (inp, r_act0)))
        l_fd_loss = args.fd_scale * self._global_mean(
            flaw_detector_criterion(fm_l[:lbs], l_fdgt))
        r_fd_loss = args.fd_scale * self._global_mean(
            flaw_detector_criterion(fm_r[:lbs], r_fdgt))
        set_lr(self.fd_opt, self.fd_lr_schedule(step))
        self._apply_updates(self.fd_opt, (l_fd_loss + r_fd_loss) / 2.0,
                            self.fd_model.parameters())

        metrics['l_fd_loss'] = l_fd_loss.detach()
        metrics['r_fd_loss'] = r_fd_loss.detach()
        metrics['lr'] = torch.tensor(self.l_lr_schedule(step),
                                     dtype=torch.float32)
        return metrics

    def _eval_fn(self, batch):
        """Both task models, ids ``l`` and ``r`` (JAX ssl_gct.py:410-421)."""
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        out = {}
        for mid, model, criterion in (('l', self.l_model, self.l_criterion),
                                      ('r', self.r_model, self.r_criterion)):
            resulter = model(inp)
            out[mid] = (resulter['activated_pred'],
                        criterion(resulter['pred'], gt, inp))
        return out

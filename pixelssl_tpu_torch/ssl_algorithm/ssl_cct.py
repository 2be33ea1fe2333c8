"""CCT, cross-consistency training (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_cct.py``; reference
pixelssl/ssl_algorithm/ssl_cct.py).

    Ouali et al., "Semi-Supervised Semantic Segmentation with
    Cross-Consistency Training", CVPR'20.

* the task model and auxiliary decoders from seven perturbation families,
  in the order VAT, dropout, guided cutout, context masking, object
  masking, feature drop, feature noise (``models/cct_decoders.py``), each
  an ``UpsampleDecoder`` over the task model's latent (``sslcct_ad_inp``;
  ssl_cct.py:133-187,542-745). The task model is ``main`` and the decoders
  ``ads.ad_<i>`` of one wrapped module, the JAX package's names;
* the decoders are one optimizer group of the task model's SGD, at ``lr *
  --ad-lr-scale`` (ssl_cct.py:435-436), apart from the task model's
  name-based lr rules;
* a labeled forward for the supervised loss, then an unlabeled forward,
  each a BN batch of its own in that order (ssl_cct.py:243-254). The
  detached main logits guide the cutout and masking decoders; the detached
  softmax is the target; every decoder reads the latent undetached, and
  its output, resized to the target and activated by the task hook, gives
  an MSE; ``cons_loss`` is their mean, ramped and scaled
  (ssl_cct.py:459-486,233-237); one backward, one SGD step;
* VAT's inner gradient is taken with respect to its perturbation only.

The decoders' draws come from ``_draw_decoder_noise(step, latent_shape)``,
which the tests replace on the instance to hand over the JAX package's.

Under ``--spatial-train`` the decoders run row-sharded on the latent's
global height (``map_height``), the draws are one draw at the global
latent's shape of which the rank keeps its samples and rows
(``_local_draws``), and the MSEs are shares (``spatial.sample_mean``).
"""

import torch
import torch.nn as nn

from ..models import cct_decoders as cct
from ..models.layers import resize_bilinear
from ..models.pspnet import UpsampleDecoder
from ..nn.func import split_tensor_tuple
from ..parallel import spatial
from ..utils import cmd, logger
from ..utils.constant import CLASSIFICATION
from .ssl_base import SSLBase, TaskContext


def add_parser_arguments(parser):
    """Flags match reference ssl_cct.py:37-63."""
    parser.add_argument('--cons-scale', type=float, default=-1,
                        help='sslcct - consistency coefficient')
    parser.add_argument('--cons-rampup-epochs', type=int, default=-1,
                        help='sslcct - consistency ramp-up epochs')
    parser.add_argument('--ad-lr-scale', type=float, default=-1,
                        help='sslcct - aux decoder lr scale')
    parser.add_argument('--vat-dec-num', type=int, default=0)
    parser.add_argument('--vat-dec-xi', type=float, default=1e-6)
    parser.add_argument('--vat-dec-eps', type=float, default=2.0)
    parser.add_argument('--drop-dec-num', type=int, default=0)
    parser.add_argument('--drop-dec-rate', type=float, default=0.5)
    parser.add_argument('--drop-dec-spatial', type=cmd.str2bool, default=True)
    parser.add_argument('--cut-dec-num', type=int, default=0)
    parser.add_argument('--cut-dec-erase', type=float, default=0.4)
    parser.add_argument('--cut-dec-components', type=int, default=2,
                        help='sslcct - erase one box per top-N foreground '
                             'component (reference per-contour semantics, '
                             'ssl_cct.py:623-646); 0 = one union-bbox box')
    parser.add_argument('--context-dec-num', type=int, default=0)
    parser.add_argument('--object-dec-num', type=int, default=0)
    parser.add_argument('--fn-dec-num', type=int, default=0)
    parser.add_argument('--fn-dec-uniform', type=float, default=0.3)
    parser.add_argument('--fd-dec-num', type=int, default=0)


def ssl_cct(args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
            task_func, **ctx_kwargs):
    if not len(model_dict) == len(optimizer_dict) == len(lrer_dict) == len(criterion_dict) == 1:
        logger.log_err('ssl_cct requires exactly one model/optimizer/lrer/'
                       'criterion')
    if list(model_dict.keys()) != ['model']:
        logger.log_err('ssl_cct requires component dicts keyed `model`')
    ctx = TaskContext(args, model_dict, optimizer_dict, lrer_dict,
                      criterion_dict, task_func, **ctx_kwargs)
    return SSLCCT(args, ctx)


def decoder_specs(args):
    """(family, options) of each auxiliary decoder, in the JAX order."""
    return ([('vat', {'xi': args.vat_dec_xi, 'eps': args.vat_dec_eps})] *
            args.vat_dec_num +
            [('drop', {'rate': args.drop_dec_rate,
                       'spatial': args.drop_dec_spatial})] * args.drop_dec_num +
            [('cut', {'erase': args.cut_dec_erase,
                      'components': args.cut_dec_components})] *
            args.cut_dec_num +
            [('context', {})] * args.context_dec_num +
            [('object', {})] * args.object_dec_num +
            [('fdrop', {})] * args.fd_dec_num +
            [('fnoise', {'uniform': args.fn_dec_uniform})] * args.fn_dec_num)


class WrappedCCTModule(nn.Module):
    """The task model under ``main`` and the decoders under ``ads``; its
    forward is the task model's."""

    def __init__(self, main, ads):
        super(WrappedCCTModule, self).__init__()
        self.main = main
        self.ads = nn.ModuleDict(ads)

    def forward(self, inp):
        return self.main(inp)

    def param_groups(self, ad_lr_mult):
        """The task model's groups, then the decoders' at ``ad_lr_mult``."""
        groups = self.main.param_groups()
        if len(self.ads):
            groups.append({'params': list(self.ads.parameters()),
                           'lr_mult': ad_lr_mult})
        return groups


def apply_decoder(spec, dec, latent, main_pred, draw, h=None):
    """One perturbation of the latent, then the decoder (reference
    ssl_cct.py:463-470); ``h``: the latent's global height in a spatial
    context."""
    family, cfg = spec
    h = latent.shape[2] if h is None else h

    def decode(x):
        return dec(x, h)
    if family == 'vat':
        return decode(latent + cct.vat_perturbation(
            decode, latent, draw, cfg['xi'], cfg['eps']))
    if family == 'drop':
        perturb = (cct.spatial_dropout if cfg['spatial']
                   else cct.element_dropout)
        return decode(perturb(latent, draw, cfg['rate']))
    if family == 'cut':
        mask = cct.guided_cutout_mask(main_pred, draw[0], draw[1],
                                      cfg['erase'], (h, latent.shape[3]),
                                      n_components=cfg['components'])
        return decode(latent * mask.to(latent.dtype))
    if family in ('context', 'object'):
        return decode(cct.guided_masking(latent, main_pred,
                                         family == 'context', h))
    if family == 'fdrop':
        return decode(cct.feature_dropout(latent, draw))
    if family == 'fnoise':
        return decode(cct.feature_noise(latent, draw))
    raise ValueError('unknown decoder family {0}'.format(family))


def draw_decoder_noise(specs, generator, latent_shape, device):
    """The draw of each decoder of ``specs`` for a latent of
    ``latent_shape`` (NCHW), in order: None for the masking decoders,
    which draw nothing."""
    b = latent_shape[0]
    draws = []
    for family, cfg in specs:
        if family == 'vat':
            draws.append(cct.draw_vat(generator, latent_shape, device))
        elif family == 'drop':
            shape = (tuple(latent_shape[:2]) + (1, 1) if cfg['spatial']
                     else latent_shape)
            draws.append(cct.draw_keep(generator, shape, cfg['rate'], device))
        elif family == 'cut':
            draws.append(cct.draw_cutout(generator, b, cfg['components'],
                                         device))
        elif family == 'fdrop':
            draws.append(cct.draw_feature_drop(generator, b, device))
        elif family == 'fnoise':
            draws.append(cct.draw_feature_noise(
                generator, latent_shape[1:], cfg['uniform'], device))
        else:
            draws.append(None)
    return draws


class SSLCCT(SSLBase):
    NAME = 'ssl_cct'
    SUPPORTED_TASK_TYPES = [CLASSIFICATION]

    def __init__(self, args, ctx):
        super(SSLCCT, self).__init__(args, ctx)
        self.specs = decoder_specs(args)
        if (ctx.ubs or 0) > 0:
            if not self.specs:
                logger.log_err('ssl_cct requires at least one auxiliary '
                               'decoder')
            if args.cons_scale < 0:
                logger.log_err('ssl_cct requires --cons-scale >= 0')
            if args.cons_rampup_epochs < 0:
                logger.log_err('ssl_cct requires --cons-rampup-epochs >= 0')
            if args.ad_lr_scale < 0:
                logger.log_err('ssl_cct requires --ad-lr-scale >= 0')
        self.criterion = ctx.criterions['model']
        opt = ctx.optimizers['model']
        self.lr_schedule = ctx.lrers['model'].make(
            opt.base_lr, ctx.iters_per_epoch, args.epochs)

    def _build_modules(self, generator):
        args = self.args
        task_func = self.ctx.task_func
        main = self.ctx.models['model'](args)
        main.init_weights(generator)
        ads = {}
        for i in range(len(self.specs)):
            dec = UpsampleDecoder(int(task_func.sslcct_ad_in_channels()),
                                  int(task_func.sslcct_ad_out_channels()),
                                  int(task_func.sslcct_ad_upsample_scale()),
                                  bf16=getattr(args, 'bf16', True))
            dec.init_weights(generator)
            ads['ad_{0}'.format(i)] = dec
        self.model = WrappedCCTModule(main, ads)
        return {'model': self.model}

    def _build_optimizers(self):
        self.opt = self.ctx.optimizers['model'].make(
            self.model.param_groups(max(self.args.ad_lr_scale, 0.0)))
        return {'opt': self.opt}

    def _draw_decoder_noise(self, step, latent_shape):
        """Each decoder's draw for step ``step`` from this step's
        generator."""
        return draw_decoder_noise(self.specs, self._step_rng(step),
                                  latent_shape, self.device)

    def _local_draws(self, draws, h):
        """Under ``--spatial-train``, this rank's part of each decoder's
        draw at the global latent's shape (``h`` rows): the unlabeled
        samples of its data coordinate and, where the draw is a map, its
        rows (slices: a captured step copies nothing from the host); the
        draws themselves otherwise."""
        if not self.mesh.spatial:
            return draws
        ubs = self.ctx.ubs
        s0 = self.mesh.data_rank * ubs
        r0, r1 = spatial.local_rows(h, self.mesh)
        out = []
        for (family, cfg), draw in zip(self.specs, draws):
            if family == 'cut':
                draw = tuple(u[s0:s0 + ubs] for u in draw)
            elif family == 'fnoise':
                draw = draw[:, r0:r1]
            elif family == 'vat' or (family == 'drop' and
                                     not cfg['spatial']):
                draw = draw[s0:s0 + ubs, :, r0:r1]
            elif draw is not None:  # [B,C,1,1] or [B,1,1,1] a sample
                draw = draw[s0:s0 + ubs]
            out.append(draw)
        return out

    def _step_fn(self, batch):
        args = self.args
        ctx = self.ctx
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        lbs = ctx.lbs
        ubs = ctx.ubs or 0
        l_inp = split_tensor_tuple(inp, 0, lbs)
        l_gt = split_tensor_tuple(gt, 0, lbs)

        # the labeled rows, then the unlabeled: two BN batches in turn
        l_resulter = self.model(l_inp)
        task_loss = self._global_mean(
            self.criterion(l_resulter['pred'], l_gt, l_inp))
        cons_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if ubs > 0:
            ul_resulter = self.model(split_tensor_tuple(inp, lbs, lbs + ubs))
            latent = ul_resulter['sslcct_ad_inp']
            main_pred = ul_resulter['pred'][0].detach()
            ad_gt = ul_resulter['activated_pred'][0].detach().float()
            height = spatial.global_height(ad_gt)
            h = self.model.main.map_height('sslcct_ad_inp', height)
            shape = tuple(latent.shape)
            if self.mesh.spatial:  # the global unlabeled batch and latent
                shape = (ubs * self.mesh.data_size, shape[1], h, shape[3])
            draws = self._local_draws(
                self._draw_decoder_noise(self.state.step, shape), h)
            ad_preds = []
            for i, (spec, draw) in enumerate(zip(self.specs, draws)):
                dec = self.model.ads['ad_{0}'.format(i)]
                ad_preds.append(resize_bilinear(
                    apply_decoder(spec, dec, latent, main_pred, draw,
                                  h).float(), (height, ad_gt.shape[3]),
                    align_corners=False, h=dec.out_height(h)))
            activated = ctx.task_func.sslcct_activate_ad_preds(ad_preds)
            mses = [self._global_mean(spatial.sample_mean(
                torch.square(a - ad_gt))) for a in activated]
            cons_loss = self._rampup(args.cons_rampup_epochs,
                                     args.cons_scale) * (sum(mses) / len(mses))

        lr = self._set_lr(self.opt, self.lr_schedule)
        self._apply_updates(self.opt, task_loss + cons_loss,
                            self.model.parameters())
        return {'task_loss': task_loss.detach(),
                'cons_loss': cons_loss.detach(),
                'lr': lr}

    def _eval_fn(self, batch):
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        resulter = self.model(inp)
        return {self.NAME: (resulter['activated_pred'],
                            self.criterion(resulter['pred'], gt, inp))}

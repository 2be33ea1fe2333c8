"""SupOnly, the supervised baseline (counterpart of
``pixelssl_tpu/ssl_algorithm/ssl_null.py``; reference
pixelssl/ssl_algorithm/ssl_null.py:26-244).

One task model trained with the task criterion on labeled data only, SGD
with the poly schedule; unlabeled data is refused (ssl_null.py:80-83).
"""

import torch

from ..nn.optimizer import set_lr
from ..utils import logger
from ..utils.constant import REGRESSION, CLASSIFICATION
from .ssl_base import SSLBase, TaskContext


def add_parser_arguments(parser):
    pass


def ssl_null(args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
             task_func, **ctx_kwargs):
    """Export function (reference ssl_null.py:26-40): checks the component
    dicts and instantiates the algorithm."""
    if not len(model_dict) == len(optimizer_dict) == len(lrer_dict) == len(criterion_dict) == 1:
        logger.log_err('ssl_null requires exactly one model/optimizer/lrer/'
                       'criterion (keyed `model`)')
    if list(model_dict.keys()) != ['model']:
        logger.log_err('ssl_null requires component dicts keyed `model`, '
                       'got {0}'.format(list(model_dict.keys())))
    ctx = TaskContext(args, model_dict, optimizer_dict, lrer_dict,
                      criterion_dict, task_func, **ctx_kwargs)
    return SSLNULL(args, ctx)


class SSLNULL(SSLBase):
    NAME = 'ssl_null'
    SUPPORTED_TASK_TYPES = [REGRESSION, CLASSIFICATION]

    def __init__(self, args, ctx):
        super(SSLNULL, self).__init__(args, ctx)
        if (ctx.ubs or 0) > 0:
            logger.log_err('ssl_null does not support unlabeled data - '
                           'set unlabeled_batch_size to 0')
        self.criterion = ctx.criterions['model']
        opt = ctx.optimizers['model']
        self.lr_schedule = ctx.lrers['model'].make(
            opt.base_lr, ctx.iters_per_epoch, args.epochs)

    def _build_modules(self, generator):
        self.model = self.ctx.models['model'](self.args)
        self.model.init_weights(generator)
        return {'model': self.model}

    def _build_optimizers(self):
        self.opt = self.ctx.optimizers['model'].make(self.model.param_groups())
        return {'opt': self.opt}

    def _step_fn(self, batch):
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        step = self.state.step
        pred = self.model(inp)['pred']
        loss = self._global_mean(self.criterion(pred, gt, inp))
        set_lr(self.opt, self.lr_schedule(step))
        self._apply_updates(self.opt, loss, self.model.parameters())
        return {'task_loss': loss.detach(),
                'lr': torch.tensor(self.lr_schedule(step),
                                   dtype=torch.float32)}

    def _eval_fn(self, batch):
        inp, gt = tuple(batch['inp']), tuple(batch['gt'])
        resulter = self.model(inp)
        return {self.NAME: (resulter['activated_pred'],
                            self.criterion(resulter['pred'], gt, inp))}

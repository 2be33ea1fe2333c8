"""The port's SupOnly (``ssl_null``) against the JAX package's: three train
steps on the same weights (carried across by
``pixelssl_tpu_torch.models.from_jax``) and the same batch, and the refusal
of unlabeled data.

The steps run at lr 5e-5 for the reason tests/test_torch_mt.py gives: at
the recipe's 2.5e-4 this ResNet-10 toy diverges and amplifies float32
noise tenfold a step. Tolerances as there: rtol 2e-3 on the task loss and
the lr, terminal params atol 3e-4, BN running statistics atol 1e-4 with
rtol 1e-4.
"""

import numpy as np
import pytest

from pixelssl_tpu_torch import harness
from pixelssl_tpu_torch.ssl_algorithm import ssl_null
from pixelssl_tpu_torch.utils import logger

from test_torch_gct import _assert_close
from test_torch_mt import (ITERS_PER_EPOCH, MT_ARGS, _jax_and_port,  # noqa: F401
                           one_torch_thread, run_steps)

NULL_ARGS = dict(MT_ARGS, unlabeled_batch_size=0)


def test_null_three_steps_match_jax():
    rng = np.random.default_rng(12)
    jalgo, jstate, jbatch, algo, batch = _jax_and_port('ssl_null', NULL_ARGS,
                                                       rng)
    final, history = run_steps(jalgo, jstate, jbatch, algo, batch,
                               ('task_loss', 'lr'), {})
    assert all(h['task_loss'] > 0 for h in history)
    _assert_close(algo.model, final['model'], 3e-4, 1e-4, 'model')


def test_null_refuses_unlabeled_data():
    args = harness.default_args('ssl_null', **dict(NULL_ARGS,
                                                   unlabeled_batch_size=2))
    with pytest.raises(logger.FatalError, match='unlabeled'):
        harness.build_algorithm(args, device='cpu',
                                iters_per_epoch=ITERS_PER_EPOCH)


def test_null_export_checks_component_dicts():
    args = harness.default_args('ssl_null', **NULL_ARGS)
    with pytest.raises(logger.FatalError, match='exactly one'):
        ssl_null.ssl_null(args, {'model': 1, 'other': 2}, {'model': 1},
                          {'model': 1}, {'model': 1}, None, device='cpu')
    with pytest.raises(logger.FatalError, match='keyed `model`'):
        ssl_null.ssl_null(args, {'net': 1}, {'net': 1}, {'net': 1},
                          {'net': 1}, None, device='cpu')

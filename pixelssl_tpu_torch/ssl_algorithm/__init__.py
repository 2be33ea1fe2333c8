"""SSL algorithm registry (counterpart of
``pixelssl_tpu/ssl_algorithm/__init__.py``); this slice ports GCT only."""

from . import ssl_base  # noqa: F401
from . import ssl_gct

SSL_GCT = ssl_gct.SSLGCT.NAME

_MODULES = {
    ssl_gct.SSLGCT.NAME: ssl_gct,
}

SSL_ALGORITHMS = sorted(_MODULES.keys())


def get_module(name):
    if name not in _MODULES:
        from ..utils import logger
        logger.log_err('Unknown SSL algorithm `{0}`. Valid: {1}'.format(
            name, SSL_ALGORITHMS))
    return _MODULES[name]


def get_builder(name):
    """The export function, e.g. ssl_gct.ssl_gct."""
    return getattr(get_module(name), name)

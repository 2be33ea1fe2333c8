"""Small shared helpers (counterpart of ``pixelssl_tpu/utils/tool.py``;
reference pixelssl/utils/tool.py:4-16)."""

from . import logger

_UNSET = object()


def dict_value(d, key, err_msg=None, default=_UNSET):
    """``d[key]`` when set; else ``default`` when given; else an error."""
    if key in d and d[key] is not None:
        return d[key]
    if default is not _UNSET:
        return default
    logger.log_err(err_msg or 'Required key `{0}` missing from dict'.format(key))

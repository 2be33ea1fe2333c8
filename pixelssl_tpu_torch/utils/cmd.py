"""Command-line value parsing (counterpart of ``pixelssl_tpu/utils/cmd.py``;
reference pixelssl/utils/cmd.py)."""


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise ValueError('Unsupported value encountered: {0}'.format(v))

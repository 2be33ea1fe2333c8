"""Dict config -> argv -> argparse (counterpart of
``pixelssl_tpu/utils/cmd.py``; reference pixelssl/utils/cmd.py:10-59).

An experiment script defines an ``OrderedDict``; ``parse_args`` writes it
out as command-line flags and parses them with the parser that every layer
added its flags to, so ``--help`` works and a real command line can
override any key. Dict flags are Python literals (``ast.literal_eval``):
a script passes real dicts, and ``str(dict)`` is one.
"""

import argparse
import ast
import sys

from . import logger


def parse_args(parser, config=None, cli_override=True):
    """Parse ``config`` as argv; with ``cli_override`` the process's own
    ``sys.argv[1:]`` follows it and wins. A tool with its own command line
    passes ``False``, or its flags would reach this parser, where argparse's
    prefix matching can bind them to lookalikes. Unknown flags are logged
    and ignored."""
    argv = []
    if config is not None:
        for key, value in config.items():
            argv.append('--' + str(key).replace('_', '-'))
            argv.append(str(value))
    if cli_override:
        argv += sys.argv[1:]
    args, unknown = parser.parse_known_args(argv)
    for token in unknown:
        if token.startswith('--'):
            logger.log_warn('Unknown argument: {0}'.format(token))
    return args


def print_args(args):
    logger.log_info('Arguments:')
    for key, value in sorted(vars(args).items()):
        logger.log_info('  {0:<28}: {1}'.format(key, value))


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise ValueError('Unsupported value encountered: {0}'.format(v))


def str2intlist(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    v = v.strip().strip('[]()')
    return [int(x) for x in v.split(',') if x.strip() != '']


def str2floatlist(v):
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    v = v.strip().strip('[]()')
    return [float(x) for x in v.split(',') if x.strip() != '']


def strdict(v):
    """A dict flag: a dict, or a Python literal of one."""
    if isinstance(v, dict):
        return v
    try:
        value = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        raise argparse.ArgumentTypeError(
            'dict literal expected, got {0!r}'.format(v))
    if not isinstance(value, dict):
        raise argparse.ArgumentTypeError(
            'dict literal expected, got {0!r}'.format(v))
    return value

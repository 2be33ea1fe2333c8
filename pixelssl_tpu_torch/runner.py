"""Script entry point (counterpart of ``pixelssl_tpu/runner.py``;
reference pixelssl/runner.py:12-41).

``run_script(config, proxy_module, proxy_class)`` builds an argparse parser
from every layer's ``add_parser_arguments``, writes the config dict out as
argv, parses it, builds the task proxy on ``device`` and runs it.
"""

import argparse
import sys

from . import ssl_algorithm
from .nn import lrer, optimizer
from .utils import cmd, logger


def create_parser(ssl_algorithm_name):
    parser = argparse.ArgumentParser(description='PixelSSL on PyTorch/CUDA')
    optimizer.add_parser_arguments(parser)
    lrer.add_parser_arguments(parser)
    ssl_algorithm.get_module(ssl_algorithm_name).add_parser_arguments(parser)
    return parser


def run_script(config, proxy_module, proxy_class, device='cuda',
               cli_override=True):
    """Run the experiment ``config`` on ``device`` (the card unless the
    caller asks for the CPU); returns the proxy. With ``cli_override`` the
    process's command line overrides config keys and ``--help`` prints
    every flag; a tool with its own command line passes ``False``."""
    if cli_override and ('--help' in sys.argv or '-h' in sys.argv):
        parser = create_parser(config.get('ssl_algorithm', 'ssl_null'))
        proxy_module.add_parser_arguments(parser)
        parser.parse_args()
        return None

    algo = config.get('ssl_algorithm')
    if not algo:
        logger.log_err('Config must define `ssl_algorithm`')

    parser = create_parser(algo)
    proxy_module.add_parser_arguments(parser)
    args = cmd.parse_args(parser, config, cli_override=cli_override)
    cmd.print_args(args)

    task_proxy = proxy_class(args, device=device)
    task_proxy.run()
    return task_proxy

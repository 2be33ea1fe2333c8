"""Pixel-regression proxy (counterpart of
``pixelssl_tpu/tasks/sreg/proxy.py``): the REGRESSION task type, whose
``--ignore-index`` is a float GT value (255.0; real GT lies in [0, 1]).
CCT and CutMix support CLASSIFICATION only, and the algorithm build
refuses them here."""

from ...task_template import proxy_template
from ...utils.constant import REGRESSION
from . import criterion, data, func, model


def add_parser_arguments(parser):
    proxy_template.add_parser_arguments(parser)
    data.add_parser_arguments(parser)
    model.add_parser_arguments(parser)

    parser.add_argument('--ignore-index', type=float, default=255.0,
                        metavar='',
                        help='sreg - GT value of invalid pixels (validation '
                             'padding); real GT lies in [0, 1]')


class PixelRegressionProxy(proxy_template.TaskProxy):
    NAME = 'sreg'
    TASK_TYPE = REGRESSION

    def __init__(self, args, device='cuda'):
        super(PixelRegressionProxy, self).__init__(
            args, func, data, model, criterion, device=device)

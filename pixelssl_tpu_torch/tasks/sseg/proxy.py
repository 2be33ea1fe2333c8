"""Semantic-segmentation proxy (counterpart of
``pixelssl_tpu/tasks/sseg/proxy.py``; reference task/sseg/proxy.py:6-24)."""

from ...task_template import proxy_template
from ...utils.constant import CLASSIFICATION
from . import criterion, data, func, model


def add_parser_arguments(parser):
    proxy_template.add_parser_arguments(parser)
    data.add_parser_arguments(parser)
    model.add_parser_arguments(parser)

    parser.add_argument('--num-classes', type=int, default=21, metavar='',
                        help='sseg - number of categories')
    parser.add_argument('--ignore-index', type=int, default=255, metavar='',
                        help='sseg - GT value ignored in loss/metrics '
                             '(semantic boundaries)')


class SemanticSegmentationProxy(proxy_template.TaskProxy):
    NAME = 'sseg'
    TASK_TYPE = CLASSIFICATION

    def __init__(self, args, device='cuda'):
        super(SemanticSegmentationProxy, self).__init__(
            args, func, data, model, criterion, device=device)

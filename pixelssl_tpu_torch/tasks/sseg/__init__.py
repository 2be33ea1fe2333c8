from . import criterion, func, model
from ... import task_template


def add_parser_arguments(parser):
    """Flags of the sseg task this slice reads (names and defaults of
    pixelssl_tpu/tasks/sseg/{proxy,model}.py)."""
    task_template.add_parser_arguments(parser)
    parser.add_argument('--num-classes', type=int, default=21, metavar='',
                        help='sseg - number of classes')
    parser.add_argument('--ignore-index', type=int, default=255, metavar='',
                        help='sseg - label value ignored by the criterion')
    model.add_parser_arguments(parser)

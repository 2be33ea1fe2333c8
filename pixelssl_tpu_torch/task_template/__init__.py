import ast

from . import criterion, func, model
from . import criterion as criterion_template
from . import func as func_template
from . import model as model_template


def add_parser_arguments(parser):
    """Experiment and batch flags this slice reads (names and defaults of
    pixelssl_tpu/task_template/proxy.py:42-131)."""
    parser.add_argument('--seed', type=int, default=0, metavar='',
                        help='exp - global random seed')
    parser.add_argument('--epochs', type=int, default=1, metavar='',
                        help='train - total epochs')
    parser.add_argument('--batch-size', type=int, default=16, metavar='',
                        help='train - batch size per device')
    parser.add_argument('--unlabeled-batch-size', type=int, default=0,
                        metavar='', help='train - unlabeled samples per batch')
    parser.add_argument('--labeled-batch-size', type=int, default=None,
                        metavar='', help='autoset - labeled samples per batch')
    parser.add_argument('--im-size', type=int, default=None, metavar='',
                        help='data - target input image size')
    parser.add_argument('--resume', type=str, default='', metavar='',
                        help='exp - checkpoint to resume')
    parser.add_argument('--checkpoint-path', type=str, default='', metavar='',
                        help='autoset - checkpoint dir')
    parser.add_argument('--ssl-algorithm', type=str, default='', metavar='',
                        help='ssl - algorithm name')
    parser.add_argument('--task', type=str, default='', metavar='',
                        help='autoset - task name')
    for name in ('models', 'optimizers', 'lrers', 'criterions'):
        parser.add_argument('--' + name, type=ast.literal_eval, default={},
                            metavar='', help='ssl - {component: name}')

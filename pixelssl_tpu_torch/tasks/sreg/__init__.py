from . import criterion, data, func, model, proxy
from .proxy import PixelRegressionProxy, add_parser_arguments

from . import criterion, data, func, model, proxy
from .proxy import SemanticSegmentationProxy, add_parser_arguments

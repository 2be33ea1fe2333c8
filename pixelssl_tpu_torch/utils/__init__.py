from .constant import REGRESSION, CLASSIFICATION
from .logger import (log_mode, log_file, log_info, log_debug, log_warn,
                     log_err, FatalError, AvgMeter, AvgMeterSet)
from . import cmd, device, tool

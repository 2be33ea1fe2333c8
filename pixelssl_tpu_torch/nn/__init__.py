from . import func
from . import optimizer
from . import lrer
from . import module

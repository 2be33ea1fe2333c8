from . import proxy as proxy_template
from . import func as func_template
from . import data as data_template
from . import model as model_template
from . import criterion as criterion_template

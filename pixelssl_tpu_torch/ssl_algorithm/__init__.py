"""SSL algorithm registry (counterpart of
``pixelssl_tpu/ssl_algorithm/__init__.py``): all seven algorithms of the
JAX package, SupOnly, Mean Teacher, AdvSSL, S4L, GCT, CCT and CutMix."""

from . import ssl_base  # noqa: F401
from . import (ssl_adv, ssl_cct, ssl_cutmix, ssl_gct, ssl_mt, ssl_null,
               ssl_s4l)

# the algorithm-name constants of the JAX registry (its
# ssl_algorithm/__init__.py:19-27)
SSL_NULL = ssl_null.SSLNULL.NAME
SSL_MT = ssl_mt.SSLMT.NAME
SSL_ADV = ssl_adv.SSLADV.NAME
SSL_S4L = ssl_s4l.SSLS4L.NAME
SSL_GCT = ssl_gct.SSLGCT.NAME
SSL_CCT = ssl_cct.SSLCCT.NAME
SSL_CUTMIX = ssl_cutmix.SSLCUTMIX.NAME

_MODULES = {
    ssl_null.SSLNULL.NAME: ssl_null,
    ssl_mt.SSLMT.NAME: ssl_mt,
    ssl_adv.SSLADV.NAME: ssl_adv,
    ssl_s4l.SSLS4L.NAME: ssl_s4l,
    ssl_gct.SSLGCT.NAME: ssl_gct,
    ssl_cct.SSLCCT.NAME: ssl_cct,
    ssl_cutmix.SSLCUTMIX.NAME: ssl_cutmix,
}

SSL_ALGORITHMS = sorted(_MODULES.keys())


def get_module(name):
    if name not in _MODULES:
        from ..utils import logger
        logger.log_err('Unknown SSL algorithm `{0}`. Valid: {1}'.format(
            name, SSL_ALGORITHMS))
    return _MODULES[name]


def get_builder(name):
    """The export function, e.g. ssl_gct.ssl_gct."""
    return getattr(get_module(name), name)


def build_algorithm(args, model, criterion, func, device, iters_per_epoch,
                    task_type=None, mesh=None):
    """Resolve ``args.models``/``criterions``/``lrers``/``optimizers`` in
    the task's ``model`` and ``criterion`` modules and the port's
    registries, then build ``args.ssl_algorithm`` on ``device`` and
    initialise it from ``--seed`` (JAX proxy.py:498-544). The proxy and
    the harness both build through here. With ``task_type``, an algorithm
    that does not support it is refused. The batch sizes of ``args`` are
    global: under ``torch.distributed`` each of the W ranks steps on 1/W of
    them (``parallel.make_mesh``), as the JAX build divides by its mesh;
    with ``--spatial-train N`` each data coordinate of the (W/N x N) grid
    (``parallel.make_mesh_2d``, unless ``mesh`` is given) on 1/(W/N) of
    them, and each rank on its rows."""
    from .. import parallel
    from ..nn import lrer as nnlrer
    from ..nn import optimizer as nnoptimizer
    from ..utils import logger

    model_dict, criterion_dict, optimizer_dict, lrer_dict = {}, {}, {}, {}
    for cname in args.models.keys():
        for mod, registry, kind in ((model, args.models, 'model'),
                                    (criterion, args.criterions,
                                     'criterion')):
            if not hasattr(mod, registry[cname]):
                logger.log_err('Unknown {0} `{1}` for component `{2}`'
                               .format(kind, registry[cname], cname))
        model_dict[cname] = getattr(model, args.models[cname])()
        criterion_dict[cname] = getattr(
            criterion, args.criterions[cname])()(args)
        lrer_dict[cname] = nnlrer.get(args.lrers[cname])(args)
        optimizer_dict[cname] = nnoptimizer.get(args.optimizers[cname])(args)
    task_func = func.task_func()(args)

    if mesh is None:
        mesh = parallel.make_mesh(device)
        n_spatial = int(getattr(args, 'spatial_train', 0) or 0)
        if n_spatial > 1:
            mesh = parallel.make_mesh_2d(n_spatial, mesh)
    lbs, ubs = args.labeled_batch_size, args.unlabeled_batch_size
    n_data = parallel.data_axis_size(mesh)
    if lbs % n_data or ubs % n_data:
        logger.log_err('the labeled ({0}) and unlabeled ({1}) batch sizes '
                       'must divide by the {2} ranks'.format(
                           lbs, ubs, n_data))
    algo = get_builder(args.ssl_algorithm)(
        args, model_dict, optimizer_dict, lrer_dict, criterion_dict,
        task_func, device=device, lbs=lbs // n_data,
        ubs=ubs // n_data,
        iters_per_epoch=max(1, int(iters_per_epoch or 1)), mesh=mesh)
    if task_type is not None and task_type not in algo.SUPPORTED_TASK_TYPES:
        logger.log_err('SSL algorithm {0} supports {1}, but the task is '
                       '{2}'.format(algo.NAME, algo.SUPPORTED_TASK_TYPES,
                                    task_type))
    algo.build()
    return algo

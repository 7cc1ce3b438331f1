"""Multi-device rendering and training over ``torch.distributed``.

Port of ``path_tracer_tpu/parallel``: data parallelism over pixel tiles,
one process per device in one process group (``multihost.initialize``),
a 1-D mesh over its ranks (``mesh.default_mesh``), the scene copied to
every rank; the sharded render with optional live-ray rebalancing
(``render.render_sharded``), the multi-process render
(``multihost.render_multihost``), and the differentiable step
(``train.make_train_step``), whose loss and gradients are summed over the
mesh before the update.
"""

from path_tracer_torch.parallel.mesh import default_mesh  # noqa: F401
from path_tracer_torch.parallel.render import render_sharded  # noqa: F401
from path_tracer_torch.parallel.train import (  # noqa: F401
    PARAM_FIELDS,
    apply_params,
    get_params,
    make_train_step,
)

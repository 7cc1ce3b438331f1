"""The differentiable render step on one device (``train``).

Port of ``path_tracer_tpu/parallel``'s training step. The JAX package
shards pixel tiles over a device mesh and sums gradients with ``psum``;
that, its sharded render and its multi-host setup wait for the port's
multi-device slice.
"""

from path_tracer_torch.parallel.train import (  # noqa: F401
    PARAM_FIELDS,
    apply_params,
    get_params,
    make_train_step,
)

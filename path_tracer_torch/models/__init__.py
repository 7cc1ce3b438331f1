"""The wavefront integrator and the render driver."""

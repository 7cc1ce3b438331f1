"""Progressive render viewer: a small local HTTP page that shows the latest
tonemapped frame after every pass batch (``http_viewer.ProgressiveViewer``),
a port of ``path_tracer_tpu/viewer``."""
from path_tracer_torch.viewer.http_viewer import ProgressiveViewer  # noqa: F401

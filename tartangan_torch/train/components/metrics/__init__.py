from .katib import KatibMetricsComponent  # noqa: F401
from .kubeflow_pipeline import KubeflowMetricsComponent  # noqa: F401
from .tensorboard import TensorboardComponent  # noqa: F401

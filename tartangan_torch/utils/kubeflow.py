"""Kubeflow metric-name munging: a copy of ``tartangan_tpu/utils/kubeflow.py``
(reference tartangan/utils/kubeflow.py:1-4)."""


def key_to_kf_name(k):
    """Convert a name to something Kubeflow likes."""
    return k.replace("_", "-").lower()

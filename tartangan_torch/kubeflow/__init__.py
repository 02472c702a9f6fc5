"""Kubeflow metadata-store glue: the apps that register and fetch a
dataset, and the mixin the trainer's Kubeflow checkpoint component uses
(copies of ``tartangan_tpu/kubeflow/``)."""

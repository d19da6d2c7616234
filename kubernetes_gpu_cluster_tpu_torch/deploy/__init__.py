"""Deployment surface: reference values schema -> Kubernetes manifests.

The reference's user-facing artifact is `helm install vllm/vllm-stack -f
values.yaml` driven by ``servingEngineSpec.modelSpec[]`` (reference
``values-01-minimal-example*.yaml``, ``old_README.md:1079-1082``). This
package is the PyTorch/CUDA port's equivalent: :mod:`render` ingests that
exact values schema and emits Deployment/StatefulSet/Service/router
manifests that run the port's serving engine on GPU nodes
(``nvidia.com/gpu`` resources; a ``torch.distributed`` coordinator
instead of ``raySpec`` Ray clusters).
"""

from .render import render_values, render_values_file  # noqa: F401

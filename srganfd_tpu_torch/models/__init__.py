"""Model registry of the port; importing it registers the generators."""

from srganfd_tpu_torch.models import generators  # noqa: F401  (registers archs)
from srganfd_tpu_torch.models.registry import arch_accepts, create_model, list_models

__all__ = ["arch_accepts", "create_model", "list_models"]

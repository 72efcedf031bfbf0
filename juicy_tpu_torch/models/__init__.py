"""Processor models. Importing this package registers all seven processors
of the suite, in chain order."""

from juicy_tpu_torch.models.base import (ParamSpec, ProcessorDef,
                                         get_processor, registry)

import juicy_tpu_torch.models.punch  # noqa: F401
import juicy_tpu_torch.models.saturator  # noqa: F401
import juicy_tpu_torch.models.texture  # noqa: F401
import juicy_tpu_torch.models.motion  # noqa: F401
import juicy_tpu_torch.models.width  # noqa: F401
import juicy_tpu_torch.models.cohere  # noqa: F401
import juicy_tpu_torch.models.infer  # noqa: F401

__all__ = ["ParamSpec", "ProcessorDef", "get_processor", "registry"]

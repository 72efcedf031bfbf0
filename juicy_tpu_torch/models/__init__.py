"""Processor models. Importing this package registers the ported processors:
the saturator and texture so far (ROADMAP.md, Queue 1 item 5, lists the
rest)."""

from juicy_tpu_torch.models.base import (ParamSpec, ProcessorDef,
                                         get_processor, registry)

import juicy_tpu_torch.models.saturator  # noqa: F401
import juicy_tpu_torch.models.texture  # noqa: F401

__all__ = ["ParamSpec", "ProcessorDef", "get_processor", "registry"]

"""juicy_tpu_torch: the PyTorch/CUDA port of juicy_tpu.

The JAX package ``juicy_tpu`` is the reference; this package mirrors its
module paths and function names, on float32 torch tensors, and runs its
kernels as CUDA C++ written for Hopper (``csrc/``, built at first use by
``kernels/_build.py``). It imports neither JAX nor ``juicy_tpu``.

The port is complete: it does all that the JAX package does. It has the
drift-pinned numerics and the LCG noise, the analyzer, ``Plugin`` and ``Chain`` with all seven processors
(texture's material static or one per clip), the punch, saturator, texture
and motion stage kernels and ``run_corpus``, the chain kernel, the
block-major chain executor and ``run_corpus_chain`` (with per-block
automation and per-clip materials), ``run_grouped``, serving
(``StreamServer``, on the chain kernel with per-slot parameter rows),
``analyze_fused`` and ``saturator_step_fused``: every TPU kernel of the JAX
package has its counterpart. Then the host-facing system: checkpoints
(``runtime/state.py``, JAX's file format) and ``run_corpus_resumable``,
the program API of ``Plugin``, WAV and native I/O (``runtime/wav.py``,
``runtime/native.py``), ``runtime/observe.py``, the host bridge and the
pipelined stream (``runtime/host_bridge.py``: a single stream steps through
its plugin's stage kernel, the canonical chain through the chain kernel),
the meter panel and web editor (``ui/``) and the CLI (``cli.py``,
``python -m juicy_tpu_torch``). Then the relaxed tier
(``runtime/relaxed.py``: ``relaxed_chain_stream`` over the associative
scans of ``ops/scan_utils.py`` and ``ops/envelopes.py``) and device meshes
(``parallel/mesh.py``; ``mesh=`` on ``run_corpus``, ``run_corpus_chain``,
``run_corpus_resumable`` and ``StreamServer``, and the sequence-parallel
scan of ``parallel/timeshard.py``). Every entry point runs on the CUDA card
unless the caller passes another ``device`` (``runtime/device.py``);
``device="cpu"`` is the plain route.
"""

from juicy_tpu_torch.analyzer import analyze, analyzer_init
from juicy_tpu_torch.kernels.analyzer_kernel import analyze_fused
from juicy_tpu_torch.kernels.saturator_kernel import saturator_step_fused
from juicy_tpu_torch.kernels.stage_kernels import (
    motion_stage_step, motion_stage_step_plain, punch_stage_step,
    punch_stage_step_plain, saturator_stage_step, saturator_stage_step_plain,
    texture_stage_step, texture_stage_step_plain)
from juicy_tpu_torch.models import get_processor
from juicy_tpu_torch.parallel.corpus import (corpus_metrics, run_corpus,
                                             run_corpus_chain,
                                             run_corpus_resumable)
from juicy_tpu_torch.parallel.grouping import run_grouped
from juicy_tpu_torch.parallel.mesh import Mesh, make_mesh
from juicy_tpu_torch.parallel.timeshard import sequence_parallel_linear_scan
from juicy_tpu_torch.runtime.host_bridge import (HostBridge, PipelinedStream,
                                                 StreamStep)
from juicy_tpu_torch.runtime.plugin import Chain, Plugin
from juicy_tpu_torch.runtime.relaxed import relaxed_chain_stream
from juicy_tpu_torch.runtime.serve import StreamServer
from juicy_tpu_torch.runtime.state import (load_plugin_state, load_state,
                                           save_plugin_state, save_state)
from juicy_tpu_torch.runtime.wav import read_wav, write_wav

__all__ = ["Chain", "HostBridge", "Mesh", "PipelinedStream", "Plugin",
           "StreamServer", "StreamStep", "analyze", "analyze_fused",
           "analyzer_init", "corpus_metrics",
           "get_processor", "load_plugin_state", "load_state", "make_mesh",
           "motion_stage_step", "motion_stage_step_plain",
           "punch_stage_step", "punch_stage_step_plain", "read_wav",
           "relaxed_chain_stream", "run_corpus", "run_corpus_chain",
           "run_corpus_resumable", "run_grouped", "save_plugin_state",
           "save_state", "saturator_stage_step", "saturator_stage_step_plain",
           "saturator_step_fused", "sequence_parallel_linear_scan",
           "texture_stage_step", "texture_stage_step_plain", "write_wav"]

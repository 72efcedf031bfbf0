"""The whole saturator step in one launch: PyTorch port of
juicy_tpu/kernels/saturator_kernel.py (``saturator_step_fused``).

``saturator_step_fused(plugin, params, states, blocks)`` keeps the JAX
contract: ``blocks`` [B, C, N] float32, state leaves with a leading [B],
returns ``(out, {"analyzer", "dsp": {"tone_state"}}, metrics)``, the metrics
as ``Plugin.batch_step`` gives them (the saturator has no
``finalize_metrics``, so they are the default pre/post scores).

The TPU kernel computes what the saturator stage kernel computes
(juicy_tpu/kernels/stage_kernels.py ``saturator_stage_step``): the pre lane
and the drive/skew/``tanh32``/tone/mix body in one sample loop, then the
post lane over the output. So on the card it is a launch of the same
hand-written kernel, ``csrc/saturator_stage.cu`` (``stage_kernels.
sat_lanes_cuda``), through the stage step's host code (``_sat_stage``), counted
here in ``saturator_step_fused.launches``; the plain version is the stage
kernel's (``_sat_lanes_plain``). Any B >= 1 runs: the kernel masks the
ragged edge, so JAX's 1024-clip rule is not ported.
"""

from __future__ import annotations

from juicy_tpu_torch.kernels import stage_kernels as sk


def _lanes_cuda(x, tone0, lane0, scalars):
    return sk.sat_lanes_cuda(saturator_step_fused, x, tone0, lane0, scalars)


def _step(lanes_fn, plugin, params, states, blocks):
    if plugin.defn.name != "saturator":
        raise ValueError(f"saturator_step_fused runs the saturator, not "
                         f"{plugin.defn.name!r}")
    return sk._sat_stage(lanes_fn, plugin.full_params(params), states,
                         blocks, plugin.sr)


def saturator_step_fused_plain(plugin, params, states, blocks):
    """``saturator_step_fused`` as plain PyTorch, on any device."""
    return _step(sk._sat_lanes_plain, plugin, params, states, blocks)


def saturator_step_fused(plugin, params, states, blocks):
    """The saturator step (pre-analyze → DSP → post-analyze) over [B, C, N]
    blocks in one launch of the saturator kernel for CUDA `blocks`, the
    plain version for CPU `blocks`; the drop-in of ``plugin.batch_step``."""
    if blocks.device.type == "cuda":
        return _step(_lanes_cuda, plugin, params, states, blocks)
    if blocks.device.type == "cpu":
        return saturator_step_fused_plain(plugin, params, states, blocks)
    raise ValueError(f"no saturator kernel for device {blocks.device}")


#: kernel launches made by saturator_step_fused (CUDA tensors only)
saturator_step_fused.launches = 0

"""The control of the comparison: the reference with its audio and state
held in bfloat16, the usual mixed precision (bfloat16 storage, float32
arithmetic), and the step that would tempt a program: half the bytes of
every stream between stages, of the audio out and of every state carried
from block to block (the waveguide and Haas rings among them).

``run_chain(..., precision="bfloat16")`` rounds to bfloat16 the clips, each
stage's output, and at each block's end every float state and the
analyzer lanes' values; each stage's arithmetic runs in float32.

Rounding every operation to bfloat16 as well leaves wood's, metal's and
plastic's resonators undamped (a pole radius of 0.9996 is 1.0 to
bfloat16's 8-bit mantissa) and their output overflows: such a control
gives no number to set a limit against.
"""

from __future__ import annotations

import numpy as np


def round_bf16(a):
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float32."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    bits = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def hold(tree):
    """A state dict with its float32 leaves held in bfloat16."""
    return {k: round_bf16(v) if np.asarray(v).dtype == np.float32 else v
            for k, v in tree.items()}

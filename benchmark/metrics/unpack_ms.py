"""unpack_ms: the device windows of the program's spans
``juicy.chain.unpack`` (the output permuted back to [B, 2, T], the
kernel-form state unpacked) summed per traced batch, in milliseconds
(benchmark/spans.py)."""

from benchmark import spans


def read(tr):
    return spans.phase_ms(tr, "juicy.chain.unpack")

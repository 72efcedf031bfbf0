"""chain_roofline: the least time of one block of the chain's work
(benchmark/work.py: the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s, padding clips not counted) over the device
time per block of every kernel that the port's own CUDA library launched
in the traced stretch, whatever its name, in percent."""


def read(tr):
    lib = 0.0
    for _name, s, e, own in tr.device:
        if own:
            lib += max(0.0, min(e, tr.end) - max(s, tr.start))
    blocks = tr.batches * tr.cell["blocks"]
    if lib <= 0.0 or blocks == 0:
        return None
    return 100.0 * tr.cell["bound_ms"] / (lib * 1e-3 / blocks)

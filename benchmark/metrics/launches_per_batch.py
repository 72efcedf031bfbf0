"""launches_per_batch: kernel launch calls of the host (cudaLaunchKernel
and the like) in the traced stretch, over its batches: an exact count."""


def read(tr):
    return tr.launches / tr.batches if tr.batches else None

"""setup_capture_s: seconds the program spent on CUDA graph captures (each
``GraphCache`` miss: warm-up, capture, instantiation, the loop graph's
build) since the process began, as it counts them."""

import sys


def read(run):
    graphs = sys.modules.get("cilqr_tpu_torch.utils.graphs")
    return getattr(graphs, "CAPTURE_S", None)

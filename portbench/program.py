"""What every model shares in the program (``adunet_torch``): the compute
types, the kernels' launch counters, the spans its recorder took, the
served program and its HTTP server. Only this module and the model modules
(``portbench/models/``) import the program."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def launch_counts() -> tuple:
    """(K1, K1 backward, K2, K2 backward, resize) launches so far."""
    from adunet_torch.kernels import all_launch_counts

    k1, k1b, k2, _rows, k2b, _rows_b, resize = all_launch_counts()
    return k1, k1b, k2, k2b, resize


def take_spans(lo_ns: int, hi_ns: int):
    """(the spans of the program's recorder that overlap [lo_ns, hi_ns),
    which taking empties from it; the spans its ring dropped), or None from
    a program without the recorder."""
    try:
        from adunet_torch.utils import spans
    except ImportError:
        return None
    return list(spans.take(lo_ns, hi_ns)), spans.RECORDER.dropped


def served_program(artifact_dir: str, device):
    """The artifact's ``model.pt2`` program, as the server loads it."""
    from adunet_torch.export.program import Program

    return Program(f"{artifact_dir}/model.pt2", device)


def server(artifact_dir: str, traffic: dict, device):
    from adunet_torch.cli.serve import make_server

    return make_server(artifact_dir, host="127.0.0.1", port=0,
                       batch_window_ms=float(traffic["batch_window_ms"]),
                       max_concurrent_requests=int(traffic["max_concurrent_requests"]),
                       device=str(device))

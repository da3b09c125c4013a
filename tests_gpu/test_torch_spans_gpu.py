"""The span recorder's clock on the card: the spans a served program records
(``program.copy_in``, ``program.forward``, ``program.copy_out``) laid over
the profiler's host and device events.

- Every ``program.copy_in`` holds the host's ``cudaMemcpyAsync`` call of its
  copy to the device.
- Every ``program.copy_out`` ends after the last kernel its forward
  launched: the device events matched by correlation id to the host calls
  inside its ``program.forward``.

So spans and the device trace share one clock, as the benchmark's span
readers (``portbench/lib/spans.py``) assume. CUPTI's device times can sit a
few hundred us off the host's, so the batch is large (16 x 256^2 x 3 float32
back, a copy of over a ms) and the margin between a forward's last kernel
and the end of its copy out wide. Needs a CUDA GPU and skips without one:

    python -m pytest tests_gpu/test_torch_spans_gpu.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adunet_torch.export import program
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.utils import spans

pytestmark = pytest.mark.gpu

SIZE, BATCH, CALLS = 256, 16, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _events(prof):
    """(host calls, device events): (name, start ns, end ns, correlation id)."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), int(e.start_ns()), int(e.end_ns()), int(e.correlation_id()))
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                device.append(row)
        else:
            host.append(row)
    return host, device


def _inside(rows, span):
    return [r for r in rows if span.start_ns <= r[1] and r[2] <= span.end_ns]


def test_program_spans_share_the_device_traces_clock(cuda, tmp_path):
    torch.manual_seed(0)
    model = build_super_resolution_unet(0.5, depth_override=1, input_size=SIZE,
                                        device="cuda")[0].eval()
    ep = program.export_sr_forward(model, SIZE, BATCH)
    torch.export.save(ep, str(tmp_path / program.PROGRAM_FILE))
    prog = program.Program(tmp_path / program.PROGRAM_FILE, "cuda")
    x = np.random.default_rng(1).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    prog(x)  # builds and loads the kernels, outside the profiler
    spans.take(0, 2**63)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            prog(x)
        torch.cuda.synchronize()
    got = spans.take(0, 2**63)
    host, device = _events(prof)

    def named(name):
        return sorted((s for s in got if s.name == name), key=lambda s: s.start_ns)

    copies_in, forwards, copies_out = (named(f"program.{n}")
                                       for n in ("copy_in", "forward", "copy_out"))
    assert len(copies_in) == len(forwards) == len(copies_out) == CALLS
    for span in copies_in:
        assert [r for r in _inside(host, span) if r[0] == "cudaMemcpyAsync"], span
    for fwd, out in zip(forwards, copies_out):
        assert fwd.end_ns <= out.start_ns
        launched = {r[3] for r in _inside(host, fwd) if r[3]}
        ends = [r[2] for r in device if r[3] in launched]
        assert ends, fwd  # the forward's kernels are matched
        assert max(ends) < out.end_ns, (max(ends) - out.end_ns) / 1e3

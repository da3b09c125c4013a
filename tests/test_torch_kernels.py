"""The port's kernel modules on the CPU: plain versions against the Pallas
kernels they replace, the gate, and the raise-not-fallback rules.

The CUDA kernels themselves run only on a GPU (``chip_smoke.py`` holds them
against these plain versions on the card). Here the plain versions, which
the CPU path runs, are held against the JAX reference:
- K1 against ``layer_norm_relu_reference`` and against the Pallas kernel in
  interpret mode, float32 at atol 1e-6 (same recipe, float32 rounding) and
  bf16 at atol 1e-2 (one bf16 ulp near 1-4);
- K2 against ``conv3x3_same_pallas`` (interpreted off the TPU) at
  (1, 16, 128, 64), atol 1e-4 (576-term float32 sums in another order).
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adunet.kernels import conv64 as jconv
from adunet.kernels import fused_norm as jnorm
from adunet_torch.kernels import conv64 as tconv
from adunet_torch.kernels import fused_norm as tnorm

tband = importlib.import_module("adunet_torch.kernels.resize_band")

torch.set_num_threads(2)


def _norm_data(rows, c, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, c)) * 2.0 + 0.3).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("c", [16, 32, 64, 128, 256, 512])
def test_layer_norm_relu_plain_matches_reference_f32(c):
    x, g, b = _norm_data(96, c, seed=c)
    got = tnorm.layer_norm_relu(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    want = jnorm.layer_norm_relu_reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_layer_norm_relu_plain_matches_reference_bf16():
    x, g, b = _norm_data(256, 128, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tnorm.layer_norm_relu(xb, torch.from_numpy(g), torch.from_numpy(b))
    # identical bf16 input values on both sides
    xj = jnp.asarray(xb.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want = jnorm.layer_norm_relu_reference(xj, jnp.asarray(g), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_relu_plain_matches_pallas_interpret(monkeypatch, dtype):
    monkeypatch.setenv("ADUNET_FORCE_PALLAS", "1")
    monkeypatch.setenv("ADUNET_PALLAS_INTERPRET", "1")
    x, g, b = _norm_data(96, 64, seed=2)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.to(torch.float32).numpy()).astype(getattr(jnp, dtype))
    # the Pallas kernel itself (no fallback wrapper), interpreted on the CPU
    want = jnorm._pallas_forward(xj, jnp.asarray(g), jnp.asarray(b), 1e-3)
    got = tnorm.layer_norm_relu(xt, torch.from_numpy(g), torch.from_numpy(b))
    atol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 32])
def test_narrow_layer_norm_relu_plain_matches_pallas_interpret(monkeypatch, dtype, c):
    """C = 16 and 32 (the vanilla segmentation U-Net's first level), which
    the CUDA kernel takes since its narrow-row split: the plain version
    against the Pallas kernel interpreted on the CPU, at a row count that
    fills no 1024-row block."""
    monkeypatch.setenv("ADUNET_FORCE_PALLAS", "1")
    monkeypatch.setenv("ADUNET_PALLAS_INTERPRET", "1")
    x, g, b = _norm_data(72, c, seed=c)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.to(torch.float32).numpy()).astype(getattr(jnp, dtype))
    want = jnorm._pallas_forward(xj, jnp.asarray(g), jnp.asarray(b), 1e-3)
    got = tnorm.layer_norm_relu(xt, torch.from_numpy(g), torch.from_numpy(b))
    atol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)
    assert c in tnorm.SUPPORTED_CHANNELS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 64, 512])
def test_layer_norm_relu_plain_with_conv_bias_is_the_add_then_k1(dtype, c):
    """K1 with a conv's float32 bias equals the conv's own bias add (the
    bias cast to x's type, one rounding of the sum to x's type) followed by
    K1 without one, bit for bit: the plain version and the wrapper's CPU
    paths with and without a gradient."""
    x, g, b = _norm_data(96, c, seed=c + 1)
    cb = torch.from_numpy((np.random.default_rng(c).normal(size=c) * 0.7).astype(np.float32))
    xt, gt, bt = torch.from_numpy(x).to(dtype), torch.from_numpy(g), torch.from_numpy(b)
    want = tnorm.layer_norm_relu_plain(xt + cb.to(dtype), gt, bt)
    assert want.dtype == dtype and bool((want > 0).any())
    assert torch.equal(tnorm.layer_norm_relu_plain(xt, gt, bt, 1e-3, cb), want)
    assert torch.equal(tnorm.layer_norm_relu(xt, gt, bt, 1e-3, cb), want)
    got = tnorm.layer_norm_relu(xt, gt, bt, 1e-3, cb.clone().requires_grad_(True))
    assert got.grad_fn is not None and torch.equal(got.detach(), want)


@pytest.fixture(scope="module")
def conv_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 128, 64)).astype(np.float32)
    w_hwio = (rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    return x, w_hwio, b


def test_conv3x3_plain_matches_pallas(conv_data):
    x, w_hwio, b = conv_data
    want = np.asarray(jconv.conv3x3_same_pallas(jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b)))
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    got = tconv.conv3x3_same(torch.from_numpy(x), w_oihw, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the plain version is a conv in its own right: F.conv2d agrees
    ref = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w_oihw,
                                     torch.from_numpy(b), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-4)


def test_pack_weights_tap_order(conv_data):
    _, w_hwio, _ = conv_data
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    packed = tconv.pack_weights(w_oihw).numpy()
    np.testing.assert_array_equal(packed, w_hwio.reshape(9, 64, 64))


def test_pack_weights_bf16_is_the_swizzled_k_major_layout(conv_data):
    """The bf16 kernel copies the packed weights byte for byte into shared
    memory, where wgmma reads B through a K-major, 128-byte-swizzle
    descriptor. A numpy model of that descriptor: tap t, output channel n,
    input channel k lies at byte a = 8192 t + 128 n + 2 k before the swizzle,
    and the swizzle moves a to a ^ (((a >> 7) & 7) << 4)."""
    _, w_hwio, _ = conv_data
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    packed = tconv.pack_weights_bf16(w_oihw)
    assert packed.dtype == torch.bfloat16 and tuple(packed.shape) == (9, 64, 64)
    words = packed.contiguous().view(torch.int16).numpy().reshape(-1)
    t, n, k = np.meshgrid(np.arange(9), np.arange(64), np.arange(64), indexing="ij")
    logical = 8192 * t + 128 * n + 2 * k
    physical = logical ^ (((logical >> 7) & 7) << 4)
    unpacked = words[physical // 2]  # (9, C_out, C_in) bf16 bits
    want = w_oihw.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 64, 64)
    np.testing.assert_array_equal(unpacked, want.contiguous().view(torch.int16).numpy())
    # back to OIHW: the same weights as the caller's, rounded to bf16 once
    oihw = torch.from_numpy(unpacked.copy()).view(torch.bfloat16).reshape(3, 3, 64, 64)
    assert torch.equal(oihw.permute(2, 3, 0, 1), w_oihw.to(torch.bfloat16))


def test_build_declares_every_entry_point_as_its_c_signature():
    """Every ``extern "C"`` function of the CUDA sources gets argtypes that
    match its C parameters (``c_void_p`` for each pointer and the stream, so
    ctypes never cuts a pointer to 32 bits) and an int result, checked on a
    stand-in for the loaded library."""
    import ctypes
    import re
    from pathlib import Path

    from adunet_torch.kernels import _build

    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "float": ctypes.c_float}

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    lib = FakeLib()
    _build._declare(lib)
    csrc = Path(_build.__file__).resolve().parents[1] / "csrc"
    seen = set()
    for src in _build._SOURCES:
        text = (csrc / src).read_text()
        for ret, name, params in re.findall(r'extern "C" ([\w ]+?\*?) (adunet_\w+)\(([^)]*)\)', text):
            seen.add(name)
            fn = getattr(lib, name)
            want = [ctype[" ".join(p.split()[:-1])] for p in params.split(",")] if params.strip() \
                else []
            assert fn.argtypes == want, name
            assert fn.restype == (ctypes.c_int if ret == "int" else ctypes.c_char_p), name
    assert {"adunet_layer_norm_relu", "adunet_layer_norm_relu_backward",
            "adunet_layer_norm_relu_backward_partials", "adunet_conv3x3_c64",
            "adunet_error_string"} <= seen


def test_backward_scratch_size_is_asked_once_per_device(monkeypatch):
    """K1 backward's scratch size (one (2, C) partial per block of its grid)
    comes from the library once per device, not once per launch; each device
    gets its own answer. Checked on a stand-in for the loaded library."""
    import ctypes

    calls = []

    class FakeLib:
        def adunet_layer_norm_relu_backward_partials(self, addr):
            calls.append(addr)
            ctypes.c_int.from_address(addr).value = 1056 + len(calls)
            return 0

    monkeypatch.setattr(tnorm, "_partials_per_device", {})
    lib = FakeLib()
    assert tnorm._n_partials(lib, torch.device("cuda", 0)) == 1057
    assert tnorm._n_partials(lib, torch.device("cuda", 0)) == 1057
    assert tnorm._n_partials(lib, torch.device("cuda", 1)) == 1058
    assert len(calls) == 2


class _RecordingLib:
    """A stand-in for the loaded kernel library: records each C call (name,
    arguments) and returns 0, CUDA's success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("adunet_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recording_lib(monkeypatch):
    """The wrappers' launch functions run on CPU tensors (device index -1)
    against ``_RecordingLib``, with stream handle 1234 and the backward's
    scratch size (8 partials) already known for that index."""
    from adunet_torch.kernels import _build

    lib = _RecordingLib()
    monkeypatch.setattr(_build, "library", lambda rebuild=False: lib)
    monkeypatch.setattr(_build, "current_stream", lambda index: 1234)
    monkeypatch.setattr(tnorm, "_partials_per_device", {-1: 8})
    return lib


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_launches_are_one_c_call_each(recording_lib, dtype, bias):
    """A forward launch and a backward launch make exactly one C call each,
    pass float32 gamma / beta and a conv's bias in x's type (else a null
    pointer) as they are (no copy), the device index and the stream; the
    backward's dgamma / dbeta are views of the one float32 allocation whose
    rest is the kernel's scratch of partials ((3, C) each with a bias), and
    dbias comes in x's type from an output of its own. A launch with a conv
    bias counts on the bias counters too."""
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    x = torch.zeros(96, 64, dtype=dtype)
    g, b = torch.ones(64), torch.zeros(64)
    cb = torch.zeros(64, dtype=dtype) if bias else None
    cb_ptr = cb.data_ptr() if bias else 0
    ns = 3 if bias else 2
    k1 = tnorm.layer_norm_relu
    counters = lambda: (k1.launches, k1.backward_launches,  # noqa: E731
                        k1.bias_launches, k1.bias_backward_launches)
    before = counters()
    y = tnorm._launch(x, g, b, 1e-3, cb)
    assert recording_lib.calls == [("adunet_layer_norm_relu", (
        x.data_ptr(), g.data_ptr(), b.data_ptr(), cb_ptr, y.data_ptr(), 96, 64, 1e-3, code, -1,
        1234))]
    gy = torch.zeros(96, 64, dtype=dtype)
    grads = tnorm._launch_backward(x, g, b, gy, 1e-3, cb)
    dx, dgamma, dbeta = grads[:3]
    assert len(grads) == ns + 1
    name, args = recording_lib.calls[1]
    assert len(recording_lib.calls) == 2 and name == "adunet_layer_norm_relu_backward"
    assert args[:6] == (x.data_ptr(), gy.data_ptr(), g.data_ptr(), b.data_ptr(), cb_ptr,
                        dx.data_ptr())
    assert args[9:] == (96, 64, 1e-3, code, -1, 1234)
    assert (dgamma.data_ptr(), dbeta.data_ptr(), args[8]) == (args[6], args[6] + 256,
                                                              args[6] + 512)
    assert args[7] == (grads[3].data_ptr() if bias else 0)
    if bias:
        assert (grads[3].dtype, grads[3].shape) == (dtype, (64,))
    assert dgamma.untyped_storage().data_ptr() == dbeta.untyped_storage().data_ptr()
    assert dgamma.untyped_storage().nbytes() == (2 + 8 * ns) * 64 * 4
    assert (dgamma.dtype, dgamma.shape, dbeta.shape) == (torch.float32, (64,), (64,))
    assert counters() == (before[0] + 1, before[1] + 1, before[2] + bias, before[3] + bias)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", [0, 1])
def test_k2_launch_is_one_c_call_with_the_parameters_as_held(recording_lib, halo, dtype, bias):
    """A K2 launch (either mode) is one C call handed the float32 weight and
    bias as the model holds them (their own storage, no cast or pack on the
    host; -1 for no bias), scratch for the pack on the card (9 x 64 x 64 of
    x's type, then 64 float32), the device index and the stream."""
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    x = torch.zeros(2, 16 + 2 * halo, 128, 64, dtype=dtype)
    w = torch.zeros(64, 64, 3, 3)
    b = torch.zeros(64) if bias else None
    counter = tconv.conv3x3_rows if halo else tconv.conv3x3_same
    before = counter.launches
    y = tconv._launch(x, w, b, halo)
    assert [c[0] for c in recording_lib.calls] == ["adunet_conv3x3_c64"]
    args = recording_lib.calls[0][1]
    assert args[:5] == (x.data_ptr(), w.data_ptr(), 0, b.data_ptr() if bias else None,
                        0 if bias else -1)
    assert args[5] not in (0, None, x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert args[6:] == (y.data_ptr(), 2, 16, 128, halo, code, -1, 1234)
    assert (tuple(y.shape), y.dtype, counter.launches) == ((2, 16, 128, 64), dtype, before + 1)


@pytest.mark.parametrize("x_shape, w_hwio", [
    ((2, 16, 128, 64), (3, 3, 64, 64)),
    ((8, 256, 256, 64), (3, 3, 64, 64)),
    ((2, 16, 128, 32), (3, 3, 32, 32)),
    ((2, 16, 128, 64), (3, 3, 128, 64)),
    ((2, 16, 100, 64), (3, 3, 64, 64)),
    ((2, 10, 128, 64), (3, 3, 64, 64)),
    ((2, 8, 128, 64), (3, 3, 64, 64)),
    ((2, 16, 128, 64), (5, 5, 64, 64)),
    ((2, 16, 128, 64), (1, 1, 64, 64)),
    ((16, 128, 64), (3, 3, 64, 64)),
])
def test_supported_parity(x_shape, w_hwio):
    w_oihw = (w_hwio[3], w_hwio[2], w_hwio[0], w_hwio[1]) if len(w_hwio) == 4 else w_hwio
    assert tconv.supported(x_shape, w_oihw) == jconv.supported(x_shape, w_hwio)


def test_conv3x3_rejects_unsupported_shape():
    with pytest.raises(ValueError, match="unsupported"):
        tconv.conv3x3_same(torch.zeros(1, 16, 100, 64), torch.zeros(64, 64, 3, 3), None)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("call", [
    lambda: tconv.conv3x3_same(_meta(1, 16, 128, 64), _meta(64, 64, 3, 3), None),
    lambda: tconv.conv3x3_rows(_meta(1, 18, 128, 64), _meta(64, 64, 3, 3), None),
    lambda: tnorm.layer_norm_relu(_meta(4, 64), _meta(64), _meta(64)),
    lambda: tband.resize_band(_meta(1, 16, 16, 8), (8, 8)),
], ids=["conv3x3_same", "conv3x3_rows", "layer_norm_relu", "resize_band"])
def test_wrappers_raise_on_device_without_kernel(call):
    """A tensor on neither the CPU nor CUDA gets no silent plain fallback."""
    with pytest.raises(ValueError, match="no kernel"):
        call()


def test_launch_registry_round_trips():
    """The registry's snapshot holds all ten counters, K1's two bias
    counters and then K3's last; ``all_launch_counts`` is its first seven
    (what the benchmark unpacks), whatever follows; adding a whole
    snapshot's delta reads back as that delta, a shorter one is refused, and
    the reset sets every counter to 0."""
    from adunet_torch import kernels

    saved = kernels.launch_snapshot()
    try:
        assert len(saved) == 10 and kernels.all_launch_counts() == saved[:7]
        assert len(kernels.all_launch_counts()) == 7
        assert kernels._COUNTERS[9] == (kernels.conv3x3_f32, "launches")
        delta = tuple(range(1, 11))
        kernels.add_launches(delta)
        assert kernels.launches_since(saved) == delta
        assert (tnorm.layer_norm_relu.launches, tconv.conv3x3_same.launches,
                tband.resize_band.launches, tnorm.layer_norm_relu.bias_backward_launches,
                kernels.conv3x3_f32.launches) == (
            saved[0] + 1, saved[2] + 3, saved[6] + 7, saved[8] + 9, saved[9] + 10)
        with pytest.raises(ValueError):
            kernels.add_launches(delta[:7])
        kernels.reset_launches()
        assert kernels.launch_snapshot() == (0,) * 10
    finally:
        kernels.reset_launches()
        kernels.add_launches(saved)


def test_cpu_path_never_counts_launches():
    before = (tnorm.layer_norm_relu.launches, tconv.conv3x3_same.launches)
    tnorm.layer_norm_relu(torch.ones(4, 64), torch.ones(64), torch.zeros(64))
    tconv.conv3x3_same(torch.ones(1, 16, 128, 64), torch.ones(64, 64, 3, 3), None)
    assert (tnorm.layer_norm_relu.launches, tconv.conv3x3_same.launches) == before


def test_kernel_sources_name_what_they_replace():
    """Each CUDA source names the TPU kernel it replaces and its bound."""
    from pathlib import Path

    csrc = Path(tnorm.__file__).resolve().parents[1] / "csrc"
    k1 = (csrc / "fused_norm.cu").read_text()
    k2 = (csrc / "conv64.cu").read_text()
    assert "adunet/kernels/fused_norm.py:48" in k1 and "Bound" in k1
    assert "adunet/kernels/conv64.py:132" in k2 and "Bound" in k2
    # the backward kernel and its entry point, beside the forward's
    bwd = k1[k1.index("// ----"):]
    assert "adunet/kernels/fused_norm.py:109" in bwd and "Bound" in bwd
    assert 'extern "C" int adunet_layer_norm_relu_backward(' in k1
    # the bf16 path says how it reaches its bound: TMA and wgmma
    assert "TMA" in k2 and "wgmma" in k2


def test_pack_weights_flipped_swaps_taps_and_channels(conv_data):
    """The backward's dx kernel: packed tap t, input channel i, output
    channel o hold the weight's tap 8 - t, output channel i, input channel o."""
    _, w_hwio, _ = conv_data
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    packed = tconv.pack_weights_flipped(w_oihw).numpy()
    t, i, o = np.meshgrid(np.arange(9), np.arange(64), np.arange(64), indexing="ij")
    want = w_oihw.numpy()[i, o, (8 - t) // 3, (8 - t) % 3]
    np.testing.assert_array_equal(packed, want)


@pytest.mark.parametrize("ks", [0, 1, 2, 3])
def test_bf16_dx_reads_the_forward_pack_transposed_as_the_flipped_kernel(conv_data, ks):
    """The bf16 dx kernel reads B from the forward's pack (no flipped copy)
    through an MN-major, 128-byte-swizzle descriptor at tap 8 - t, K-step ks:
    a numpy model of that descriptor. K row k (the pack's row 16 ks + k, w's
    output channel) and N value n (w's input channel) lie at byte a = 8192
    (8 - t) + 2048 ks + 128 k + 2 n before the swizzle, which moves a to a ^
    (((a >> 7) & 7) << 4). What it reads is the flipped, io-swapped kernel's
    tap t, K-step ks."""
    _, w_hwio, _ = conv_data
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    words = tconv.pack_weights_bf16(w_oihw).contiguous().view(torch.int16).numpy().reshape(-1)
    t, k, n = np.meshgrid(np.arange(9), np.arange(16), np.arange(64), indexing="ij")
    logical = 8192 * (8 - t) + 2048 * ks + 128 * k + 2 * n
    read = words[(logical ^ (((logical >> 7) & 7) << 4)) // 2]  # (tap, K = dx's in, N = dx's out)
    flipped = w_oihw.flip(2, 3).transpose(0, 1).to(torch.bfloat16)  # OIHW of dx's conv
    want = flipped.permute(2, 3, 1, 0).reshape(9, 64, 64)[:, 16 * ks: 16 * ks + 16]  # [t][in][out]
    np.testing.assert_array_equal(read, want.contiguous().view(torch.int16).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", [0, 1])
def test_k2_backward_launch_is_one_c_call(recording_lib, monkeypatch, halo, dtype):
    """A K2 backward on CUDA tensors (here the launch function on CPU
    tensors against a stand-in library) is one C call: the weight as the
    model holds it, the cotangent, the flags, one scratch of the flipped
    weights' room plus a float32 partial row per block, dx / dw / db
    allocated in x's, w's and the bias's types, the cotangent's H rows, the
    mode, the device index and the stream; its counter moves by one."""
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    monkeypatch.setattr(tconv, "_partials_per_device", {(-1, code): 8})
    x = torch.zeros(2, 16 + 2 * halo, 128, 64, dtype=dtype)
    w = torch.zeros(64, 64, 3, 3)
    g = torch.zeros(2, 16, 128, 64, dtype=dtype)
    before = (tconv.conv3x3_same_backward.launches, tconv.conv3x3_same_backward.rows_launches)
    dx, dw, db = tconv._launch_backward(x, w, g, True, True, True, torch.bfloat16, 1 - halo)
    assert [c[0] for c in recording_lib.calls] == ["adunet_conv3x3_c64_backward"]
    args = recording_lib.calls[0][1]
    assert args[:7] == (x.data_ptr(), w.data_ptr(), 0, g.data_ptr(), 1, 1, 1)
    assert args[8:] == (dx.data_ptr(), dw.data_ptr(), db.data_ptr(), 1, 2, 16, 128, halo, code,
                        -1, 1234)
    assert (dx.shape, dx.dtype, dw.shape, dw.dtype, db.shape, db.dtype) == (
        x.shape, dtype, w.shape, torch.float32, (64,), torch.bfloat16)
    after = (tconv.conv3x3_same_backward.launches, tconv.conv3x3_same_backward.rows_launches)
    assert after == (before[0] + 1 - halo, before[1] + halo)
    # dx alone: no partials, null dw / db
    recording_lib.calls.clear()
    dx, dw, db = tconv._launch_backward(x, w, g, True, False, False, None, 1 - halo)
    args = recording_lib.calls[0][1]
    assert (dw, db) == (None, None) and args[4:7] == (1, 0, 0) and args[9:11] == (None, None)


@pytest.mark.parametrize("dtype, rows", [(torch.float32, 132), (torch.bfloat16, 33),
                                         (torch.bfloat16, 17)])
def test_k2_backward_scratch_holds_the_partial_rows_c_reports(recording_lib, monkeypatch,
                                                              dtype, rows):
    """The backward's scratch is the packed weights' room and exactly the
    partial rows the library reports for x's type (one a block of the
    float32 wgrad grid, one a cluster of the bf16 one), asked once per
    device and type with the type's code; dx alone allocates no rows."""
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    asked = []

    def partials(addr, type_code):
        asked.append(type_code)
        ctypes.c_int.from_address(addr).value = rows if type_code == code else 1
        return 0

    recording_lib.adunet_conv3x3_c64_backward_partials = partials
    monkeypatch.setattr(tconv, "_partials_per_device", {})
    sizes = []
    new_empty = torch.Tensor.new_empty

    def spy(self, size, *args, **kwargs):
        out = new_empty(self, size, *args, **kwargs)
        if out.dtype == torch.uint8:
            sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch.Tensor, "new_empty", spy)
    x = torch.zeros(2, 16, 128, 64, dtype=dtype)
    w = torch.zeros(64, 64, 3, 3)
    for _ in range(2):
        tconv._launch_backward(x, w, x, True, True, True, None, 1)
    tconv._launch_backward(x, w, x, True, False, False, None, 1)
    assert asked == [code]
    pack = 9 * 64 * 64 * 4 + 64 * 4
    assert sizes == [pack + rows * (9 * 64 * 64 + 64) * 4] * 2 + [pack]
    assert [c[0] for c in recording_lib.calls] == ["adunet_conv3x3_c64_backward"] * 3


def test_k2_backward_refuses_what_the_kernels_do_not_take(recording_lib):
    x = torch.zeros(2, 16, 128, 64)
    w = torch.zeros(64, 64, 3, 3)
    with pytest.raises(TypeError):
        tconv._launch_backward(x.double(), w, x.double(), True, True, True, None, 1)
    with pytest.raises(ValueError, match="unsupported"):
        tconv._launch_backward(x, w, torch.zeros(2, 14, 128, 64), True, True, True, None, 1)
    with pytest.raises(ValueError, match="no kernel"):
        tconv.conv3x3_same_backward(x.to("meta"), w.to("meta"), x.to("meta"))
    assert recording_lib.calls == []


# ---------------------------------------------------------------- K3
tk3 = importlib.import_module("adunet_torch.kernels.conv3x3_f32")

# (C_in, C_out) of the served flagship's 9 K3 shapes (PERF.md; chip_smoke.K3_SERVE)
K3_PAIRS = [(64, 128), (128, 128), (128, 256), (256, 256), (256, 512), (512, 512), (512, 256),
            (256, 128), (128, 64)]


@pytest.mark.parametrize("cin, cout", K3_PAIRS)
def test_k3_plain_matches_conv2d(cin, cout):
    """K3's plain version (K2's channel-general 9-tap float32 sum) against
    torch's ``F.conv2d`` in float64 at a tiny ragged image: outputs of unit
    scale summed over 9 x C_in <= 4,608 float32 products, so within 1e-5."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(2, 5, 7, cin, generator=gen)
    w = torch.randn(cout, cin, 3, 3, generator=gen) * (1.0 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=gen) * 0.1
    with torch.no_grad():
        got = tk3.conv3x3_f32(x, w, b)
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), b.double(), padding=1)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 7, cout)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), atol=1e-5)
    assert tk3.conv3x3_f32_plain is tconv.conv3x3_same_plain  # reused, not copied


def test_k3_gate_takes_the_served_flagships_14_convs(monkeypatch):
    """The served flagship's forward (float32, no gradient) sends 14 convs
    to K3, at the 9 served channel pairs, and its 4 64 -> 64 convs to K2;
    only enc0.conv0 (3 -> 64) and the 1x1 head go to the library."""
    import torch.nn.functional as F

    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.nn import blocks

    taken, library, k3 = [], [], blocks.conv3x3_f32
    conv2d = F.conv2d
    monkeypatch.setattr(blocks, "conv3x3_f32",
                        lambda x, w, b: taken.append((x.shape[1], x.shape[3], w.shape[0]))
                        or k3(x, w, b))
    monkeypatch.setattr(F, "conv2d", lambda x, w, *a, **k: library.append(tuple(w.shape))
                        or conv2d(x, w, *a, **k))
    model, _ = build_super_resolution_unet(0.5, depth_override=3, device="cpu", seed=0)
    before = tconv.conv3x3_same.launches
    with torch.no_grad():
        model.eval()(torch.rand(1, 256, 256, 3))
    assert len(taken) == 14
    assert sorted({(ci, co) for _, ci, co in taken}) == sorted(K3_PAIRS)
    assert {(h, ci, co) for h, ci, co in taken} == {
        (128, 64, 128), (128, 128, 128), (64, 128, 256), (64, 256, 256), (32, 256, 512),
        (32, 512, 512), (64, 512, 256), (128, 256, 128), (256, 128, 64)}
    assert sorted(library) == [(3, 64, 1, 1), (64, 3, 3, 3)]
    assert tconv.conv3x3_same.launches == before  # the CPU counts no launch


@pytest.mark.parametrize("x_shape, w_shape, dtype, grad, ok", [
    ((8, 128, 128, 64), (128, 64, 3, 3), torch.float32, False, True),
    ((8, 32, 32, 512), (512, 512, 3, 3), torch.float32, False, True),
    ((8, 256, 256, 128), (64, 128, 3, 3), torch.float32, False, True),
    ((1, 17, 40, 8), (192, 8, 3, 3), torch.float32, False, True),
    ((8, 256, 256, 64), (64, 64, 3, 3), torch.float32, False, False),  # K2's
    ((8, 256, 256, 3), (64, 3, 3, 3), torch.float32, False, False),  # C_in = 3
    ((8, 256, 256, 64), (3, 64, 1, 1), torch.float32, False, False),  # 1x1
    ((8, 64, 64, 12), (64, 12, 3, 3), torch.float32, False, False),  # C_in % 8
    ((8, 64, 64, 64), (32, 64, 3, 3), torch.float32, False, False),  # C_out % 64
    ((8, 64, 64, 128), (128, 64, 3, 3), torch.float32, False, False),  # channels disagree
    ((8, 128, 128, 64), (128, 64, 3, 3), torch.bfloat16, False, False),
    ((8, 128, 128, 64), (128, 64, 3, 3), torch.float32, True, False),  # a gradient wanted
], ids=["served", "bottleneck", "dec0", "ragged", "k2", "rgb", "1x1", "cin", "cout",
        "mismatch", "bf16", "grad"])
def test_k3_gate(x_shape, w_shape, dtype, grad, ok):
    x = torch.zeros(x_shape, dtype=dtype, device="meta")
    w = torch.zeros(w_shape, device="meta", requires_grad=grad)
    b = torch.zeros(w_shape[0], device="meta")
    assert tk3.takes(x, w, b) == ok
    with torch.no_grad():  # no gradient is wanted under no_grad, whatever requires one
        assert tk3.takes(x, w, b) == (ok or grad)


def test_k3_gate_refuses_the_space_mesh(monkeypatch):
    """On a space mesh a 3x3 conv takes its neighbours' rows and runs VALID
    in H: never K3, whose SAME padding would read zeros there."""
    import torch.nn.functional as F

    from adunet_torch.nn import blocks

    class Edge:  # one process holds the whole image: its halo rows are zeros
        def halo(self, x, rows):
            return F.pad(x, (0, 0, 0, 0, rows, rows))

    conv = blocks.Conv(64, 128, 3)
    blocks.init_parameters(conv, 3)
    x = torch.randn(1, 6, 10, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = conv(x)
        monkeypatch.setattr(blocks, "conv3x3_f32", lambda *a: pytest.fail("K3 on a space mesh"))
        conv.space = Edge()
        got = conv(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_k3_launch_is_one_c_call_with_the_parameters_as_held(recording_lib):
    """A K3 launch is one C call handed x, the OIHW weight and the bias as
    held (null for none), scratch for the pack (9 x C_in x C_out float32),
    the output, the shape, the device index and the stream; it counts on
    K3's counter alone."""
    from adunet_torch import kernels

    x = torch.zeros(2, 5, 7, 128)
    w = torch.zeros(256, 128, 3, 3)
    for b in (torch.zeros(256), None):
        recording_lib.calls.clear()
        before = kernels.launch_snapshot()
        y = tk3._launch(x, w, b)
        [(name, args)] = recording_lib.calls
        assert name == "adunet_conv3x3_f32"
        assert args[:3] == (x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr())
        assert args[3] not in (None, x.data_ptr(), w.data_ptr(), y.data_ptr())
        assert args[4:] == (y.data_ptr(), 2, 5, 7, 128, 256, -1, 1234)
        assert (tuple(y.shape), y.dtype) == ((2, 5, 7, 256), torch.float32)
        assert kernels.launches_since(before) == (0,) * 9 + (1,)
    with pytest.raises(TypeError):
        tk3._launch(x.double(), w, None)


def test_k3_raises_where_a_gradient_is_wanted_or_the_shape_is_refused():
    x = torch.zeros(1, 4, 4, 64)
    w = torch.zeros(128, 64, 3, 3, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        tk3.conv3x3_f32(x, w, None)
    with pytest.raises(ValueError, match="unsupported"):
        tk3.conv3x3_f32(torch.zeros(1, 16, 128, 64), torch.zeros(64, 64, 3, 3), None)
    with pytest.raises(ValueError, match="no kernel"):
        tk3.conv3x3_f32(x.to("meta"), w.detach().to("meta"), None)


def test_k3_source_names_what_it_replaces_and_its_bound():
    from pathlib import Path

    k3 = (Path(tk3.__file__).resolve().parents[1] / "csrc" / "conv3x3_f32.cu").read_text()
    assert "Replaces no TPU kernel" in k3 and "Bound on an H100: operations" in k3
    assert "cp.async" in k3 and "no TF32" in k3


def test_k3_kernel_names_fall_in_no_benchmark_class():
    """The benchmark classes device time by kernel name: every ``__global__``
    of K3's source, bare and as the profiler shows a template's instance, is
    neither a library conv (``conv_lib_ms.serve``) nor K2 (``k2_roofline.serve``),
    read from the benchmark's files as they are."""
    import importlib.util
    import re
    from pathlib import Path

    root = Path(tk3.__file__).resolve().parents[2]

    def metric(name):
        spec = importlib.util.spec_from_file_location(
            "metric_" + name.replace(".", "_"), root / "portbench" / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    library, k2 = metric("conv_lib_ms.serve"), metric("k2_roofline.serve")
    src = (root / "adunet_torch" / "csrc" / "conv3x3_f32.cu").read_text()
    names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", src)
    assert sorted(names) == ["conv3x3_f32_igemm_kernel", "pack_w3x3_f32_kernel"]
    shown = [f"void adunet::(anonymous namespace)::{n}<128, 64>(float const*, float const*, "
             f"float const*, float*, int, int, int, int, int, int)" for n in names]
    for name in names + shown:
        assert not library.is_library_conv(name), name
        assert not any(s in name for s in k2.NAMES), name

"""The port's artifact loader and HTTP server against the JAX reference.

A tiny JAX SR model (perturbed, so outputs are not the identity) is exported
with int8 weight-only quantization and saved as an artifact. The port's
``load_artifact(..., device="cpu")`` must equal JAX's ``load_artifact`` call
on the same tiles (atol 1e-5: same dequantized weights, float32, another
summation order), and the port's server must serve exactly that call.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

PATCH, BATCH = 32, 4


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from adunet.export import export_sr_forward, save_artifact
    from adunet.models import build_super_resolution_unet
    from adunet.train import create_train_state, make_optimizer

    model, _ = build_super_resolution_unet(
        scale=0.5, depth_override=1, input_size=PATCH, base_channels=8,
        residual_head_channels=8,
    )
    state = create_train_state(
        model, jax.random.key(0), jnp.zeros((1, PATCH, PATCH, 3)), make_optimizer(1e-4)
    )
    leaves, treedef = jax.tree_util.tree_flatten(state.params)
    keys = jax.random.split(jax.random.key(7), len(leaves))
    state = state.replace(params=jax.tree_util.tree_unflatten(
        treedef, [l + 0.05 * jax.random.normal(k, l.shape, l.dtype) for l, k in zip(leaves, keys)],
    ))
    exported = export_sr_forward(state, patch_size=PATCH, batch_size=BATCH,
                                 platforms=("cpu",), quantize="int8")
    meta = {"model": "adaptive_sr_unet", "scale": 0.5, "depth": 1,
            "quantization": "int8-weight-only"}
    art = save_artifact(exported, tmp_path_factory.mktemp("tsrv") / "artifact", meta=meta)
    f32 = save_artifact(export_sr_forward(state, patch_size=PATCH, batch_size=BATCH,
                                          platforms=("cpu",)),
                        tmp_path_factory.mktemp("tsrv_f32") / "artifact", meta=meta)
    return art, f32


@pytest.fixture(scope="module")
def jax_call(artifact):
    from adunet.export import load_artifact

    call, _ = load_artifact(artifact[0])
    return lambda x: np.asarray(call(x))


def test_load_artifact_matches_jax(artifact, jax_call):
    from adunet_torch.export import load_artifact

    call, manifest = load_artifact(artifact[0], device="cpu")
    assert manifest["input_shape"] == [BATCH, PATCH, PATCH, 3]
    x = np.random.default_rng(0).random((BATCH, PATCH, PATCH, 3), dtype=np.float32)
    want = jax_call(x)
    got = call(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(want - x).max() > 1e-2  # not the identity
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="expected"):
        call(x[:, :16])


def test_non_quantized_artifact_is_refused(artifact):
    from adunet_torch.export import load_artifact

    with pytest.raises(ValueError, match="only weight-file artifacts"):
        load_artifact(artifact[1], device="cpu")


def test_load_artifact_refuses_cuda_without_gpu(artifact):
    from adunet_torch.export import load_artifact

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        load_artifact(artifact[0])


@pytest.fixture(scope="module")
def served(artifact):
    from adunet_torch.cli.serve import make_server

    server = make_server(str(artifact[0]), port=0, batch_window_ms=2000.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server
    server.shutdown()
    server.batcher.close()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post_npy(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


def _stats(base):
    with urllib.request.urlopen(base + "/v1/metadata", timeout=10) as r:
        return json.load(r)["serving"]


def _padded(x):
    out = np.zeros((BATCH, PATCH, PATCH, 3), np.float32)
    out[: len(x)] = x
    return out


def test_health_and_metadata(served):
    base, _ = served
    with urllib.request.urlopen(base + "/v1/health", timeout=10) as r:
        assert json.load(r)["status"] == "ok"
    with urllib.request.urlopen(base + "/v1/metadata", timeout=10) as r:
        meta = json.load(r)
    assert meta["manifest"]["input_shape"] == [BATCH, PATCH, PATCH, 3]
    assert set(meta["serving"]) == {"requests", "images", "device_calls", "batched_rows",
                                    "refused", "failed"}


def test_single_and_stacked_requests(served, jax_call):
    base, _ = served
    x = np.random.default_rng(1).random((PATCH, PATCH, 3), dtype=np.float32)
    out = _post_npy(base + "/v1/predict", x)
    assert out.shape == (1, PATCH, PATCH, 3)
    np.testing.assert_allclose(out[0], jax_call(_padded(x[None]))[0], atol=1e-5)

    before = _stats(base)
    xs = np.random.default_rng(2).random((3, PATCH, PATCH, 3), dtype=np.float32)
    out = _post_npy(base + "/v1/predict", xs)
    np.testing.assert_allclose(out, jax_call(_padded(xs))[:3], atol=1e-5)
    after = _stats(base)
    # 3 rows + zero padding to the static batch of 4: exactly one device call
    assert after["device_calls"] - before["device_calls"] == 1
    assert after["batched_rows"] - before["batched_rows"] == 3


def test_uint8_request_is_normalised(served, jax_call):
    base, _ = served
    x8 = (np.random.default_rng(3).random((PATCH, PATCH, 3)) * 255).astype(np.uint8)
    out = _post_npy(base + "/v1/predict", x8)
    want = jax_call(_padded((x8.astype(np.float32) / 255.0)[None]))[0]
    np.testing.assert_allclose(out[0], want, atol=1e-5)


def test_concurrent_rows_are_pooled(served, jax_call):
    """BATCH concurrent one-image requests fill one static batch: with a 2 s
    window the batcher waits for all of them and makes one device call."""
    base, _ = served
    xs = np.random.default_rng(4).random((BATCH, PATCH, PATCH, 3), dtype=np.float32)
    before = _stats(base)
    results = [None] * BATCH
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, _post_npy(base + "/v1/predict", xs[i]))) for i in range(BATCH)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    after = _stats(base)
    assert after["batched_rows"] - before["batched_rows"] == BATCH
    assert after["device_calls"] - before["device_calls"] == 1
    want = jax_call(xs)
    for i in range(BATCH):  # rows may sit in any batch slot: per-row equality
        np.testing.assert_allclose(results[i][0], want[i], atol=1e-5)


@pytest.mark.parametrize("body, expect", [
    (np.zeros((0, PATCH, PATCH, 3), np.float32), "expected"),
    (np.zeros((16, 16, 3), np.float32), "expected (32, 32, 3)"),
    (b"not an npy file", "not a .npy array"),
])
def test_malformed_bodies_get_400(served, body, expect):
    base, _ = served
    if isinstance(body, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, body)
        body = buf.getvalue()
    req = urllib.request.Request(base + "/v1/predict", data=body)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    assert expect in json.loads(err.value.read())["error"]


def test_oversized_body_gets_413(served):
    import http.client

    _, server = served
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=10)
    try:
        conn.putrequest("POST", "/v1/predict")
        conn.putheader("Content-Length", str(65 * 1024 * 1024))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
    finally:
        conn.close()


def test_saturation_gets_503(artifact):
    import time

    from adunet_torch.cli.serve import make_server

    server = make_server(str(artifact[0]), port=0, batch_window_ms=1000.0,
                         max_concurrent_requests=1, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        x = np.random.default_rng(5).random((PATCH, PATCH, 3), dtype=np.float32)
        first = {}
        t = threading.Thread(target=lambda: first.update(out=_post_npy(base + "/v1/predict", x)))
        t.start()
        deadline = time.monotonic() + 10
        while server.batcher.snapshot_stats()["requests"] < 1:
            assert time.monotonic() < deadline, "first request never admitted"
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post_npy(base + "/v1/predict", x)
        assert err.value.code == 503
        t.join(timeout=30)
        assert first["out"].shape == (1, PATCH, PATCH, 3)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()

"""``chip_smoke.py``'s checks that no instantiation of K1's backward row
kernel, of K2's backward kernels or of K3 spills, read from a ptxas report
written here in the form ``nvcc -Xptxas -v`` prints (the real report exists
only where ``nvcc`` runs)."""

import pytest

import chip_smoke
from adunet_torch.kernels import fused_norm

_TYPE_ARG = {"F32": "3F32", "BF16": "4BF16"}


def _properties(name: str, spill: int, registers: int) -> list[str]:
    return [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
            f"ptxas info    : Used {registers} registers, used 1 barriers, 408 bytes cmem[0]"]


def _report(spill_at=None, missing=None) -> str:
    """A report with every backward row kernel (C, type, conv bias) but
    ``missing``, a spill of 24 bytes at ``spill_at``, and the forward and
    column kernels, which the check ignores, spilling."""
    lines = ["--- fused_norm.cu"]
    lines += _properties("_ZN6adunet12_GLOBAL__N_122layer_norm_relu_kernelINS_3F32ELi4ELi16ELi32E"
                         "Lb1EEEvPKNT_7storageEPKfS8_S8_PS4_xf", 16, 255)
    lines += _properties("_ZN6adunet12_GLOBAL__N_131layer_norm_relu_bwd_cols_kernelINS_3F32EEEvPKfiiPf"
                         "PNT_7storageE", 8, 40)
    for c in fused_norm.SUPPORTED_CHANNELS:
        for t, arg in _TYPE_ARG.items():
            for b in (False, True):
                if (c, t, b) != missing:
                    lines += _properties(
                        f"_ZN6adunet12_GLOBAL__N_131layer_norm_relu_bwd_rows_kernelINS_{arg}ELi{c}E"
                        f"Lb{int(b)}EEEvPKNT_7storageES6_PKfS8_S8_PS4_Pfxf",
                        24 if (c, t, b) == spill_at else 0, c // 8 + 60)
    return "\n".join(lines)


def test_k1_bwd_spill_check_reads_every_instantiation(capsys):
    rows = chip_smoke.check_k1_bwd_spills(_report())
    assert {(r["C"], r["type"], r["bias"]) for r in rows} == chip_smoke.K1_BWD_INSTANCES
    assert len(rows) == 2 * 2 * len(fused_norm.SUPPORTED_CHANNELS)
    assert all(r["stack"] == r["spill_stores"] == r["spill_loads"] == 0 for r in rows)
    assert all(r["registers"] == r["C"] // 8 + 60 for r in rows)
    assert capsys.readouterr().out.count("[spill] K1 backward") == 32


@pytest.mark.parametrize("report, message", [
    (_report(spill_at=(2048, "BF16", False)), "spills"),
    (_report(spill_at=(16, "F32", False)), "spills"),
    (_report(missing=(1024, "F32", False)), "instantiations"),
    (_report(spill_at=(2048, "BF16", True)), "spills"),
    (_report(missing=(512, "F32", True)), "instantiations"),
])
def test_k1_bwd_spill_check_fails_on_a_spill_or_a_missing_instantiation(report, message):
    with pytest.raises(AssertionError, match=message):
        chip_smoke.check_k1_bwd_spills(report)


# K2's bf16 conv kernel in its forward and dx instantiations, then the wgrad kernels
_CONV = ["_ZN6adunet41_GLOBAL__N__63a33b8c_9_conv64_cu_a7a950122tc24conv3x3_c64_wgmma_kernelIL"
         f"b{dx}EEEv14CUtensorMap_stS3_PK5uint4PKfiiii" for dx in (0, 1)]
_WGRAD = {"conv3x3_c64_wgrad_wgmma_kernel":
          "_ZN6adunet41_GLOBAL__N__63a33b8c_9_conv64_cu_a7a950122tc30conv3x3_c64_wgrad_wgmma_"
          "kernelE14CUtensorMap_stS2_Pfiiiii",
          "conv3x3_c64_wgrad_kernel":
          "_ZN6adunet41_GLOBAL__N__63a33b8c_9_conv64_cu_a7a9501224conv3x3_c64_wgrad_kernelEPKfS2_"
          "Pfiiiiii",
          "conv3x3_c64_wgrad_reduce_kernel":
          "_ZN6adunet41_GLOBAL__N__63a33b8c_9_conv64_cu_a7a9501231conv3x3_c64_wgrad_reduce_"
          "kernelINS_3F32ES2_S2_EEvPKfiiiPNT0_7storageEPNT1_7storageE"}


def _k2_report(spill_at=None, missing=None) -> str:
    """A conv64.cu report with K2's float32 forward kernel (spilling, which
    this check ignores), its bf16 conv kernel (forward and dx) and the
    backward's dw + db kernels but ``missing``, ``spill_at`` spilling 16
    bytes."""
    lines = ["--- conv64.cu"]
    lines += _properties("_ZN6adunet41_GLOBAL__N__63a33b8c_9_conv64_cu_a7a9501218conv3x3_c64_"
                         "kernelEPKfS2_S2_Pfiiiii", 8, 128)
    named = [("conv3x3_c64_wgmma_kernel", name) for name in _CONV] + list(_WGRAD.items())
    for kernel, name in named:
        if kernel != missing:
            lines += _properties(name, 16 if kernel == spill_at else 0, 160)
    return "\n".join(lines)


def test_k2_bwd_spill_check_reads_every_wgrad_kernel(capsys):
    rows = chip_smoke.check_k2_bwd_spills(_k2_report())
    assert {r["kernel"] for r in rows} == set(chip_smoke.K2_BWD_KERNELS)
    assert all(r["registers"] == 160 and r["spill_stores"] == 0 for r in rows)
    # the bf16 conv kernel's forward and dx instantiations, the wgrad kernels and their sum
    assert capsys.readouterr().out.count("[spill] K2 backward") == 5


@pytest.mark.parametrize("report, message", [
    (_k2_report(spill_at="conv3x3_c64_wgrad_wgmma_kernel"), "spills"),
    (_k2_report(spill_at="conv3x3_c64_wgrad_kernel"), "spills"),
    (_k2_report(missing="conv3x3_c64_wgrad_kernel"), "no"),
    (_k2_report(spill_at="conv3x3_c64_wgmma_kernel"), "spills"),
    (_k2_report(missing="conv3x3_c64_wgmma_kernel"), "no"),
])
def test_k2_bwd_spill_check_fails_on_a_spill_or_a_missing_kernel(report, message):
    with pytest.raises(AssertionError, match=message):
        chip_smoke.check_k2_bwd_spills(report)


_K3 = ("_ZN6adunet47_GLOBAL__N__338f8a8c_14_conv3x3_f32_cu_3576c38924conv3x3_f32_igemm_kernelILi"
       "{co}ELi{wt}EEEvPKfS3_S3_Pfiiiiii")
_K3_PACK = ("_ZN6adunet47_GLOBAL__N__338f8a8c_14_conv3x3_f32_cu_3576c38920pack_w3x3_f32_kernelEPK"
            "fPfii")


def _k3_report(spill_at=None, missing=None) -> str:
    """A conv3x3_f32.cu report with K3's conv in each (CO, WT) instantiation
    but ``missing`` and its weight pack, ``spill_at`` spilling 8 bytes."""
    lines = ["--- conv3x3_f32.cu"]
    for co, wt in sorted(chip_smoke.K3_INSTANCES):
        if (co, wt) != missing:
            lines += _properties(_K3.format(co=co, wt=wt), 8 if (co, wt) == spill_at else 0, 128)
    lines += _properties(_K3_PACK, 8 if spill_at == "pack" else 0, 26)
    return "\n".join(lines)


def test_k3_spill_check_reads_every_instantiation(capsys):
    rows = chip_smoke.check_k3_spills(_k3_report())
    assert len(rows) == len(chip_smoke.K3_INSTANCES) + 1 == 7
    assert {r["kernel"] for r in rows} == set(chip_smoke.K3_KERNELS)
    assert all(r["spill_stores"] == r["spill_loads"] == 0 for r in rows)
    assert capsys.readouterr().out.count("[spill] K3") == 7


@pytest.mark.parametrize("report, message", [
    (_k3_report(spill_at=(128, 128)), "spills"),
    (_k3_report(spill_at=(64, 32)), "spills"),
    (_k3_report(spill_at="pack"), "spills"),
    (_k3_report(missing=(64, 128)), "instantiations"),
])
def test_k3_spill_check_fails_on_a_spill_or_a_missing_instantiation(report, message):
    with pytest.raises(AssertionError, match=message):
        chip_smoke.check_k3_spills(report)

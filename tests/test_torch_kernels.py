"""PyTorch port: the kernel registry (``ops.kernels``) against the JAX
package's Pallas kernels, and the site sweep's shared-memory limit.

Every function of the JAX package that ``pl.pallas_call`` runs must be
named, by file and definition line, in the ``replaces`` of a registered
kernel: a kernel that fuses two TPU kernels names both, so no TPU kernel
drops out of the registry."""

import re
from pathlib import Path

import pytest

from kafka_assignment_optimizer_tpu_torch.ops import kernels, site_cuda

ROOT = Path(__file__).resolve().parent.parent
PALLAS = ("score_pallas.py", "propose_pallas.py", "thin_pallas.py")


def _tpu_kernels() -> set[str]:
    """``"file:line function"`` of every Pallas kernel body."""
    out = set()
    for name in PALLAS:
        rel = f"kafka_assignment_optimizer_tpu/ops/{name}"
        lines = (ROOT / rel).read_text().splitlines()
        for i, line in enumerate(lines, 1):
            m = re.match(r"def (_\w+_kernel)\(", line)
            if m:
                out.add(f"{rel}:{i} {m.group(1)}")
    return out


def test_registry_names_every_tpu_kernel():
    named = {r for k in kernels.KERNELS for r in k.replaces}
    tpu = _tpu_kernels()
    assert len(tpu) == 6
    assert named == tpu
    site = kernels.SITE.replaces
    assert [r.split()[1] for r in site] == ["_propose_kernel",
                                            "_site_finish_kernel"]
    exch = kernels.EXCHANGE.replaces
    assert [r.split()[1] for r in exch] == ["_exchange_kernel",
                                            "_exch_maps_kernel",
                                            "_exch_finish_kernel"]


def test_registry_sources_exist():
    for k in kernels.KERNELS:
        assert k.source in kernels.SOURCES
        assert (kernels.CSRC / f"{k.source}.cu").exists()
    assert len({k.name for k in kernels.KERNELS}) == len(kernels.KERNELS)
    # B6 lives in the fused exchange launch: no source of its own
    assert kernels.SOURCES == ("score", "site", "exchange")
    assert not (kernels.CSRC / "thin.cu").exists()


# (brokers + 1, racks + 1): the main path's shape; 2,000 brokers in 64
# racks; the most brokers the site sweep takes, whose CTA share (4 * (4 *
# ceil((B+1)/8) + ceil((K+1)/8)) bytes of at most 232,448) binds first (B1
# counts in device memory where its histograms do not fit in shared
# memory, so it takes any broker count)
_SITE_TOP = 8 * ((site_cuda.SMEM_LIMIT // 4 - -(-65 // 8)) // 4)
SHAPES = [(257, 9), (2_001, 65), (_SITE_TOP, 65)]


@pytest.mark.parametrize("B1, K1", SHAPES)
def test_site_sweep_shared_memory(B1, K1):
    # a CTA holds its share of two maps and three deltas, independent of
    # the partition count: every partition bucket fits
    C = site_cuda.CLUSTER
    assert site_cuda.smem_bytes(B1, K1) == 4 * (4 * -(-B1 // C) + -(-K1 // C))
    assert site_cuda.smem_bytes(B1, K1) <= site_cuda.SMEM_LIMIT
    if B1 == _SITE_TOP:
        assert site_cuda.smem_bytes(B1 + C, K1) > site_cuda.SMEM_LIMIT


def test_site_sweep_cluster_size():
    # the wrapper's CTAs per chain are the kernel's built-in default
    src = (kernels.CSRC / "site.cu").read_text()
    m = re.search(r"#define KAO_SITE_CLUSTER (\d+)", src)
    assert m and int(m.group(1)) == site_cuda.CLUSTER
    assert site_cuda.smem_bytes(257, 9) == 4 * (4 * 33 + 2)


def test_site_probe_refuses_without_the_card(monkeypatch, capsys):
    """site_probe.py (the site kernel's build-variant timer) imports only
    the standard library and chip_smoke at module level, and exits
    non-zero without building or printing anything when there is no
    card."""
    import ast
    import sys

    import torch

    tree = ast.parse((ROOT / "site_probe.py").read_text())
    top = {al.name.split(".")[0] for node in tree.body
           if isinstance(node, ast.Import) for al in node.names}
    assert top - set(sys.stdlib_module_names) == {"chip_smoke"}
    monkeypatch.syspath_prepend(str(ROOT))
    import site_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert site_probe.main([]) != 0
    assert "site_variants" not in capsys.readouterr().out

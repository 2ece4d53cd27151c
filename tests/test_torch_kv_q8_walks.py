"""The production int8 decode cells walk partitioned.

``build_decode_cell(arch, "decode_32k", mesh, kv_quant=True)`` for the
dense (phi3-mini-3.8b, qwen2.5-32b), MoE (olmoe-1b-7b,
deepseek-moe-16b) and vlm (internvl2-76b) archs on the meta device,
under a fake world of 256 ranks (16 x 16) and of 512 (2 x 16 x 16),
the production meshes of the dry run.  Each walk runs the int8 kernel's
split form in every attention layer (the four stages declared once a
layer, never the one launch), and every rank holds 1/world of each
int8 payload and fp16 scale cache (batch 128 over the data ranks,
32768 positions over model).  Counts and bytes are exact.  phi3 on
16 x 16, with its bytes a device spelled out, is
``tests/test_torch_partition_kv_q8.py::
test_production_int8_decode_walks_partitioned``.  ~55 s in one process.
"""
import pytest

torch = pytest.importorskip("torch")

ARCHS = ("phi3-mini-3.8b", "qwen2.5-32b", "olmoe-1b-7b",
         "deepseek-moe-16b", "internvl2-76b")
STAGES = ("decode_q8_scores", "decode_q8_exp", "decode_q8_pv",
          "decode_q8_pq")
CACHE_LEAVES = ("k", "v", "k_scale", "v_scale")
CASES = [(arch, multi_pod) for arch in ARCHS for multi_pod in (False, True)
         if (arch, multi_pod) != ("phi3-mini-3.8b", False)]


@pytest.mark.parametrize("arch,multi_pod", CASES, ids=[
    f"{a}-{'2x16x16' if mp else '16x16'}" for a, mp in CASES])
def test_int8_decode_32k_walks_partitioned(arch, multi_pod):
    from repro_torch.launch import cells
    from repro_torch.launch import mesh as mesh_mod
    ms = mesh_mod.production_mesh_shape(multi_pod=multi_pod)
    world = 512 if multi_pod else 256
    with mesh_mod.fake_world(ms.shape, ms.mesh_dim_names,
                             device_type="cpu") as mesh:
        cell = cells.build_decode_cell(arch, "decode_32k", mesh,
                                       kv_quant=True)
        cost, _ = cell.walk()
        caches, shard = cell.args[1], cell.in_shardings[1]
        stages = [s for s in caches if isinstance(caches[s], dict)]
        per_dev = {(s, n): cells.leaf_bytes_per_device(
            caches[s][n], shard[s][n], mesh)
            for s in stages for n in CACHE_LEAVES}
        whole = {(s, n): caches[s][n].numel() * caches[s][n].element_size()
                 for s in stages for n in CACHE_LEAVES}
    assert cell.partitioned and cell.static_desc == "decode kv-int8"
    assert stages
    for name in STAGES:
        assert cost.declared[name]["calls"] == cell.cfg.num_layers, name
    assert "decode_attention_q8" not in cost.declared
    assert all(per_dev[key] * world == whole[key] for key in whole), (
        per_dev, whole)

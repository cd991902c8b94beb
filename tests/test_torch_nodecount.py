"""``chip_smoke.NodeCount``, the count of the megakernel's DFS work per pixel
and per warp that ``chip_smoke.py``'s phase 19 prints, held against the same
counts taken directly from the records, pixel by pixel and warp by warp.
The records are the plain record version's (on the card, K5's, which equal
them)."""
import numpy as np
import pytest

import tpuray_torch as tt
from tpuray_torch.kernels.megakernel import (
    TRI_CODE, render_megakernel_record_reference)

import chip_smoke

# (width, height, depth): a 16-aligned image and a ragged one whose last
# block column and row are partly outside it
SHAPES = [(32, 16, 4), (40, 20, 6)]


def direct_counts(rec, n_solids, width, height):
    """Per pixel nodes and solid nodes, and per warp (16x16 blocks, 2 rows
    of 16 lanes a warp, warps with a lane in the image) the most of each
    over the lanes, by loops over the records."""
    krec = rec.shape[0]
    nodes = np.zeros((height, width), int)
    solid = np.zeros((height, width), int)
    for y in range(height):
        for x in range(width):
            for s in range(krec):
                r = int(rec[s, y * width + x])
                if r < 0:
                    continue
                nodes[y, x] += 1
                code = r & 0xFF
                solid[y, x] += code < n_solids or code == TRI_CODE
    trips, solid_trips = [], []
    for by in range(0, height, 16):
        for bx in range(0, width, 16):
            for w in range(8):
                lanes = [(y, x) for y in (by + 2 * w, by + 2 * w + 1)
                         for x in range(bx, bx + 16)
                         if y < height and x < width]
                if lanes:
                    trips.append(max(nodes[p] for p in lanes))
                    solid_trips.append(max(solid[p] for p in lanes))
    return nodes, solid, np.array(trips), np.array(solid_trips)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}"
                                                        f"d{s[2]}")
def test_node_count_equals_the_records(shape):
    width, height, depth = shape
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 64, 64), "cpu")
    basis = tt.perspective_basis(tt.Camera(*chip_smoke.GOLDEN_CAMERA), width,
                                 height, device="cpu")
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          shadow_samples=1)
    packed = tt.pack_scene(scene, basis)
    _, rec = render_megakernel_record_reference(packed, assets, cfg)
    count = chip_smoke.NodeCount(rec, packed.layout, width, height)
    got = count.summary(deep=5)
    nodes, solid, trips, solid_trips = direct_counts(
        rec["rec"].numpy(), scene.num_spheres + scene.num_planes, width,
        height)
    np.testing.assert_array_equal(count.nodes.numpy(), nodes)
    np.testing.assert_array_equal(count.solid.numpy(), solid)
    assert got["nodes"] == nodes.sum() and got["solid"] == solid.sum()
    assert got["nodes_per_pixel"] == round(nodes.sum() / nodes.size, 3)
    assert got["warps"] == len(trips) == len(solid_trips)
    assert got["trips_mean"] == round(trips.mean(), 3)
    assert got["trips_max"] == trips.max()
    assert got["warps_deep"] == (trips >= 5).sum()
    assert got["pixels_deep"] == (nodes >= 5).sum()
    assert got["efficiency"] == round(solid.sum() / (32 * solid_trips.sum()),
                                      3)
    # every node was recorded, so the true maximum is the records' maximum
    assert got["max_nodes"] == nodes.max() > 5

"""The ring kernel's launch geometry on the CPU: ``ops/cuda_mhd.ring_zrun``
picks the run of z planes a block walks from the shape of the region it
computes (a whole field for B9, a whole shard for B11, the interior for
B13) and the card's SM count (pure integers). The kernel itself runs only
on the card (``tests/test_torch_gpu.py``); on the CPU its wrappers run
the twins."""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from stencil_tpu_torch.ops import cuda_mhd_overlap as mo


def _cost(Z, Y, X, n_sms, zrun):
    blocks = -(-X // 32) * -(-Y // 16) * -(-Z // zrun)
    return -(-blocks // n_sms) * (zrun + 2 * cm.R)


@pytest.mark.parametrize("shape", [(256, 256, 256), (512, 256, 256),
                                   (128, 128, 128), (64, 64, 64),
                                   (16, 8, 24), (24, 16, 40), (256, 8, 8),
                                   # B13's interiors: 256^3, 104 x 128 x
                                   # 96 and 8 x 8 x 5 shards
                                   (250, 250, 256), (98, 122, 96),
                                   (2, 2, 5)])
@pytest.mark.parametrize("n_sms", [132, 114, 8])
def test_zrun_takes_the_fewest_waves_times_planes(shape, n_sms):
    Z, Y, X = shape
    zrun = cm.ring_zrun(Z, Y, X, n_sms)
    assert 1 <= zrun <= Z
    best = min(_cost(Z, Y, X, n_sms, r) for r in range(1, Z + 1))
    assert _cost(Z, Y, X, n_sms, zrun) == best


def test_zrun_on_the_main_path_shard():
    """A 256^3 shard on an H100 (132 SMs): 128 columns of 32 x 16 fill
    the card once, so each block walks the whole z extent; a shard with
    too few columns splits z into runs."""
    assert cm.ring_zrun(256, 256, 256, 132) == 256
    assert cm.ring_zrun(128, 128, 128, 132) == 32
    # the card test's shard: z split into runs, the last one shorter
    assert cm.ring_zrun(136, 128, 96, 132) == 28


@pytest.mark.parametrize("shard,zrun", [((256, 256, 256), 250),
                                        ((104, 128, 96), 20),
                                        ((8, 8, 5), 1)])
def test_zrun_over_the_b13_interior(shard, zrun):
    """B13 launches the ring kernel over ``interior_region`` only: on a
    256^3 shard its 128 (x, y) tiles fill 132 SMs once, so a block walks
    all 250 interior planes; on a 104 x 128 x 96 shard the 98 planes
    split into runs of 20, the last one 18."""
    Z, Y, X = shard
    z0, nz, y0, ny = mo.interior_region(Z, Y, pair=False)
    assert (z0, y0) == (cm.R, cm.R)
    assert cm.ring_zrun(nz, ny, X, 132) == zrun


def test_cpu_tensors_take_the_twin():
    g = np.random.default_rng(5)
    f = {q: torch.from_numpy(g.normal(0, 0.1, (8, 8, 12)).astype(np.float32))
         for q in FIELDS}
    slabs = {q: {"zlo": f[q][-3:], "zhi": f[q][:3],
                 "ylo": torch.cat([f[q][-3:], f[q], f[q][:3]])[:, -3:],
                 "yhi": torch.cat([f[q][-3:], f[q], f[q][:3]])[:, :3]}
             for q in FIELDS}
    prm = MhdParams(dt=1e-4)
    cm.reset_launch_counts()
    ref = cm.mhd_substep_halo_plain(f, None, slabs, 0, prm, 1e-4)
    got = cm.mhd_substep_halo_cuda(f, None, slabs, 0, prm, 1e-4)
    for q in FIELDS:
        assert torch.equal(got[0][q], ref[0][q])
        assert torch.equal(got[1][q], ref[1][q])
    assert cm.LAUNCHES["mhd_substep_halo"] == 0
    # on one shard the slabs are the wrapped rows: B11's twin is B9's
    wf, ww = cm.mhd_substep_wrap_plain(f, None, 0, prm, 1e-4)
    for q in FIELDS:
        assert torch.equal(ref[0][q], wf[q])
        assert torch.equal(ref[1][q], ww[q])

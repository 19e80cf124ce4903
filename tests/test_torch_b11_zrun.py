"""B11's launch geometry on the CPU: ``ops/cuda_mhd.b11_zrun`` picks the
run of z planes a block walks from the shard's shape and the card's SM
count (pure integers). The kernel itself runs only on the card
(``tests/test_torch_gpu.py``); on the CPU its wrapper runs the twin."""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm


def _cost(Z, Y, X, n_sms, zrun):
    blocks = -(-X // 32) * -(-Y // 16) * -(-Z // zrun)
    return -(-blocks // n_sms) * (zrun + 2 * cm.R)


@pytest.mark.parametrize("shape", [(256, 256, 256), (512, 256, 256),
                                   (128, 128, 128), (64, 64, 64),
                                   (16, 8, 24), (24, 16, 40), (256, 8, 8)])
@pytest.mark.parametrize("n_sms", [132, 114, 8])
def test_zrun_takes_the_fewest_waves_times_planes(shape, n_sms):
    Z, Y, X = shape
    zrun = cm.b11_zrun(Z, Y, X, n_sms)
    assert 1 <= zrun <= Z
    best = min(_cost(Z, Y, X, n_sms, r) for r in range(1, Z + 1))
    assert _cost(Z, Y, X, n_sms, zrun) == best


def test_zrun_on_the_main_path_shard():
    """A 256^3 shard on an H100 (132 SMs): 128 columns of 32 x 16 fill
    the card once, so each block walks the whole z extent; a shard with
    too few columns splits z into runs."""
    assert cm.b11_zrun(256, 256, 256, 132) == 256
    assert cm.b11_zrun(128, 128, 128, 132) == 32
    # the card test's shard: z split into runs, the last one shorter
    assert cm.b11_zrun(136, 128, 96, 132) == 28


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

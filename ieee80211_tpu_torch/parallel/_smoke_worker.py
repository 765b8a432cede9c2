"""Worker process for the multi-process mesh smoke test.

Port of ieee80211_tpu/parallel/_smoke_worker.py. Launched N times (by
tests/test_torch_distributed.py, or by hand for a bring-up dry run), one
CPU rank per process over gloo:

    MASTER_ADDR=localhost MASTER_PORT=29512 WORLD_SIZE=2 RANK=0 \
    LOCAL_WORLD_SIZE=2 python -m ieee80211_tpu_torch.parallel._smoke_worker

Each process joins the process group, builds the global (dp x sp) mesh
with sp = 2, and proves on it:
  1. an all-reduce over both mesh axes crosses the process boundary,
  2. the halo-exchange front-end on a process-spanning capture matches the
     single-process reference computed locally from the same numpy input.
Prints one "SMOKE OK ..." line on success; any mismatch raises.
"""
import numpy as np
import torch
import torch.distributed as dist

from ieee80211_tpu_torch.ops import sync
from ieee80211_tpu_torch.parallel import distributed as pdist
from ieee80211_tpu_torch.parallel.sharded import HALO, sharded_frontend


def main():
    torch.set_num_threads(1)
    multi = pdist.init_distributed(device="cpu")
    info = pdist.process_summary()
    assert multi and info["process_count"] >= 2, f"not multi-process: {info}"
    mesh = pdist.make_global_phy_mesh(sp=2, device="cpu")
    n_dp, n_sp = mesh.mesh.shape
    assert n_sp == 2 and n_dp == info["global_devices"] // 2

    # 1. cross-process collective over both mesh axes
    total = torch.ones(())
    dist.all_reduce(total, group=mesh.get_group("sp"))
    dist.all_reduce(total, group=mesh.get_group("dp"))
    assert float(total) == n_dp * n_sp, f"all_reduce {float(total)}"

    # 2. halo-exchange front-end parity on a process-spanning capture
    b, t = 2 * n_dp, 4096
    rng = np.random.default_rng(0)
    host = rng.standard_normal((b, t, 2)).astype(np.float32) * 0.1
    ac = sharded_frontend(mesh, host).numpy()
    # reference on the local copy of the same data, zero-padded by HALO so
    # the output covers all T samples like the sharded version
    padded = np.concatenate([host, np.zeros((b, HALO, 2), np.float32)],
                            axis=1)
    want = sync.stf_autocorr(torch.view_as_complex(
        torch.from_numpy(padded)))[:, :t].numpy()
    want[:, -HALO:] = 0.0
    np.testing.assert_allclose(ac, want, atol=1e-4, rtol=1e-3)

    print(f"SMOKE OK process {info['process_index']}/"
          f"{info['process_count']} mesh dp={n_dp} sp={n_sp}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

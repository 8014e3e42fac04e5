"""One rank of the port's enc-dec serving on a mesh over gloo on the CPU.

    python tests/_torch_encdec_serve_worker.py <rank> <world> <dir>

``tests/test_torch_encdec_serving_dsp.py`` starts ``world`` (4) of these
on one ``FileStore`` in ``dir``, beside ``params.npz`` and ``inputs.npz``.
For each scenario of ``_torch_encdec_serve_jax.SCENARIOS`` the rank lays
the whole parameters out by ``param_pspecs`` of ``ParallelPlan(mode=
"dsp", zero=)``, keeps its slices, and serves its shard of the batch
(``lm.shard_lm_batch``): ``encdec.prefill(sharder=)`` into caches of
``MAX_LEN`` positions and ``STEPS`` ``decode_step(sharder=)``s on its
batch slice of the forced tokens, each followed by ``encdec.argmax``.  It
writes to ``dir/rank<r>.npz`` its coordinate, each step's logits, its
cache blocks after the prefill and after the last step with their
bounds (``kv_block``), the calls and bytes of the prefill and of each
step beside ``encdec.serve_contract``'s, and whether a frame count or a
cache length the model ranks do not divide is refused.  Every rank waits
at a barrier, then leaves the group, before it exits."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models.lm import shard_lm_batch, tree_map  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, kv_block, make_sharder, mesh_sizes, param_pspecs,
    shard_params)

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_encdec_jax import CONFIG_KW  # noqa: E402
from _torch_encdec_serve_jax import (BATCH, CONFIG, MAX_LEN,  # noqa: E402
                                     S_DEC, S_ENC, SCENARIOS, STEPS,
                                     UNEVEN_ENC)
from _torch_lmdsp_worker import KINDS  # noqa: E402


def counted(out, key):
    out[f"{key}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    out[f"{key}/bytes"] = np.array([dsp.volume.get(k, 0) for k in KINDS])
    dsp.reset_calls()


def contract(out, key, want):
    out[f"{key}/contract_calls"] = np.array([want["calls"].get(k, 0)
                                             for k in KINDS])
    out[f"{key}/contract_bytes"] = np.array([want["bytes"].get(k, 0)
                                             for k in KINDS])


def caches_out(out, key, caches):
    for path, v in flatten(caches["periods"]).items():
        out[f"{key}/{path}"] = v.numpy().copy()


def scenario(out, name, cfg, whole, raw, shape, zero):
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    plan = ParallelPlan(mode="dsp", zero=zero)
    specs = param_pspecs(whole, plan, axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(mesh, plan, param_specs=specs)
    params = shard_params(whole, specs, ctx)
    local = shard_lm_batch({"feats": torch.from_numpy(raw["feats"]),
                            "tokens": torch.from_numpy(raw["tokens"]).long()},
                           sharder)
    # the decode tokens: the rank's batch slice, whole on its model ranks
    forced = dsp.shard(torch.from_numpy(raw["forced"]).long(), 0,
                       ctx.dp_size, ctx.dp_index)
    meta = tree_map(lambda a: a.to("meta"), whole)
    n, dp = shape[1], shape[0]
    out[f"{name}/coord"] = np.array([ctx.dp_index, ctx.sp_index])
    out[f"{name}/kv_block"] = np.array(kv_block(ctx, plan, MAX_LEN))
    out[f"{name}/cross_block"] = np.array(kv_block(ctx, plan, S_ENC))
    dsp.reset_calls()
    with torch.no_grad():
        logits, caches = ED.prefill(params, local, cfg, sharder=sharder,
                                    backend="ref", max_len=MAX_LEN)
        ED.argmax(logits, cfg, sharder)
        counted(out, f"{name}/prefill")
        contract(out, f"{name}/prefill", ED.serve_contract(
            cfg, n, meta, plan, dp=dp, prefill=(BATCH, S_ENC, S_DEC)))
        out[f"{name}/prefill/logits"] = logits.numpy()
        caches_out(out, f"{name}/prefill", caches)
        for i in range(STEPS):
            logits, caches = ED.decode_step(params, forced[:, i:i + 1],
                                            caches, cfg, sharder=sharder)
            ED.argmax(logits, cfg, sharder)
            counted(out, f"{name}/step{i}")
            out[f"{name}/step{i}/logits"] = logits.numpy()
        contract(out, f"{name}/step", ED.serve_contract(
            cfg, n, meta, plan, dp=dp, decode=BATCH))
        caches_out(out, f"{name}/last", caches)
    refused = []
    try:
        shard_lm_batch({"feats": torch.zeros(BATCH, UNEVEN_ENC, 4)}, sharder)
    except ValueError:
        refused.append("frames")
    try:
        ED.init_dec_caches(cfg, BATCH, MAX_LEN + 1, S_ENC, device="cpu",
                           sharder=sharder)
    except ValueError:
        refused.append("max_len")
    out[f"{name}/refused"] = np.array(refused)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        cfg = ED.EncDecConfig(**CONFIG_KW[CONFIG], dtype=torch.float32)
        whole = bridge.params_from_numpy(unflatten(dict(np.load(
            os.path.join(work, "params.npz")))), device="cpu")
        for name, (shape, zero) in SCENARIOS.items():
            scenario(out, name, cfg, whole, raw, shape, zero)
    finally:
        # no rank leaves while another's gloo threads still talk to it
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()

"""Worker processes of ``tests/test_torch_parallel.py``: one rank of a gloo
group on the CPU, started with ``torch.multiprocessing`` by ``run_group``
(``parallel/bootstrap.spawn``: a timeout, and a rank still running then
killed by its PID).
It imports no JAX (the spawned interpreters import only this module and the
port).  Each rank runs the jobs named in ``inputs["jobs"]`` and saves what it
found to ``<outdir>/rank<r>.pt`` for the test process to compare."""

from __future__ import annotations

import os

import torch


def run_group(n: int, outdir: str, inputs: dict, timeout: float = 120.0) -> list[dict]:
    """Start ``n`` ranks on a free port with ``inputs``; wait at most
    ``timeout`` seconds, kill any rank still running by its PID, and return
    each rank's results."""
    from hex_gym_env_tpu_torch.parallel.bootstrap import free_port, spawn

    torch.save(inputs, os.path.join(outdir, "inputs.pt"))
    spawn(_rank_main, n, (n, free_port(), outdir), timeout)
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def _rank_main(rank: int, n: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    from hex_gym_env_tpu_torch.parallel import bootstrap, make_mesh

    inputs = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    out = {"init": bootstrap.init_distributed(f"localhost:{port}", n, rank, backend="gloo"),
           "is_main": bootstrap.is_main_process()}
    mesh = make_mesh("cpu")
    out["mesh"] = (mesh.world_size, mesh.rank)
    for job in inputs["jobs"]:
        out[job] = JOBS[job](mesh, inputs, outdir)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _eval_job(mesh, inputs, outdir):
    """``eval_step`` on a fresh state of ``inputs["eval_cfg"]`` whose pool
    scores are ``inputs["eval_scores"]``."""
    from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO

    algo = DistributedSelfplayPPO(inputs["eval_cfg"], mesh)
    state = algo.init_sharded_state(inputs["eval_seed"])
    state.bank.scores = inputs["eval_scores"].clone()
    state, res = algo.eval_step(state)
    return {"rewards": res.rewards, "score": res.score, "replaced": res.replaced,
            "bank_scores": state.bank.scores, "bank": state.bank.params}


def _update_job(mesh, inputs, outdir):
    """The data-parallel sweep on this rank's rows with its injected
    permutations, for each case of ``inputs["update"]``."""
    from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO
    from hex_gym_env_tpu_torch.train import ppo

    results = []
    for case in inputs["update"]:
        algo = DistributedSelfplayPPO(case["cfg"], mesh)
        batch = ppo.PPOBatch(*(x[mesh.rank] for x in case["batch"]))
        params, opt, stats = algo.dist_update_fn(
            case["params"], case["opt"], batch, None, perms=case["perms"][mesh.rank])
        results.append({"params": params, "mu": opt.mu, "nu": opt.nu, "count": opt.count,
                        "stats": torch.stack(list(stats)), "reduces": algo.grad_reduces})
    return results


def _fit_job(mesh, inputs, outdir):
    """Two ``Trainer.fit`` iterations with a checkpoint after each; then a
    run resumed from the first checkpoint to the second iteration."""
    import dataclasses

    from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO
    from hex_gym_env_tpu_torch.train.trainer import Trainer, _NullLogger
    from hex_gym_env_tpu_torch.utils import checkpoint as ckpt_lib

    saves = []
    save = ckpt_lib.CheckpointManager.save

    def counted_save(self, step, state):
        saves.append(step)
        return save(self, step, state)

    ckpt_lib.CheckpointManager.save = counted_save
    cfg = inputs["fit_cfg"]
    trainer = Trainer(cfg, algo=DistributedSelfplayPPO(cfg, mesh))
    state = trainer.fit()
    per_iter = trainer.algo.per_iter
    cfg_r = dataclasses.replace(cfg, model_name=cfg.model_name + "_resumed")
    trainer_r = Trainer(cfg_r, algo=DistributedSelfplayPPO(cfg_r, mesh))
    start = trainer_r.algo.shard_state(
        trainer._ckpt_mgr().restore(step=per_iter, map_location=mesh.device))
    resumed = trainer_r.fit(start)
    ckpt_lib.CheckpointManager.save = save
    return {"params": state.params, "resumed": resumed.params, "saves": saves,
            "null_logger": isinstance(trainer.logger, _NullLogger),
            "iteration": state.iteration, "carry_envs": state.carry.agent_seat.shape[0]}


JOBS = {"eval": _eval_job, "update": _update_job, "fit": _fit_job}

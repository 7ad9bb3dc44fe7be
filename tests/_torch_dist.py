"""Rank processes for the port's data-parallel tests on the CPU.

``spawn(case, world, tmp_path, **params)`` starts ``world`` processes of
this file, each joining a gloo group through the file store
``{tmp_path}/store`` (no port to race for under xdist; a single rank
joins none and runs the plain path) with one torch thread, runs
``CASES[case](rank, world, tmp_path, **params)`` in each and returns
their results (``{tmp_path}/rank{r}.pt``). A rank that fails, or
ranks still running at the timeout (a deadlock), kill every rank and fail
the test. The rank processes import torch, numpy and the port only; the
tests hand them their inputs as files in ``tmp_path``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The port's tiny CLI recipe of tests/test_torch_cli.py, 2 ranks of
# --batch_size 2 over 16 samples: 4 steps an epoch.
TINY = (
    "--ds_name synthetic --num_data_samples 16 --mlp_dim 8 --headcount 2 "
    "--epochs 1 --batch_size 2 --num_frames 4 --train_crop_size 32 "
    "--aud_sample_rate 16000 --aud_spec_type 1 --nopts 1 --match true "
    "--bn_warmup_batches 1 --workers 0 --compute_dtype float32 "
    "--sk_agg_batch 3 --base_lr 0.01 --wd 0.00001"
)


def spawn(case: str, world: int, tmp_path, timeout: float = 120.0,
          **params) -> list:
    return Ranks(case, world, tmp_path, **params).results(timeout)


class Ranks:
    """The ranks of ``case``, started; ``results(timeout)`` waits for them
    (the caller may work meanwhile). Each rank's output goes to
    ``{tmp_path}/rank{r}.log``: a pipe that nobody reads could stall a rank
    and, through its collectives, the others."""

    def __init__(self, case: str, world: int, tmp_path, **params):
        self.case, self.tmp = case, str(tmp_path)
        with open(os.path.join(self.tmp, "params.json"), "w") as f:
            json.dump(params, f)
        env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(key, None)
        self.logs = [os.path.join(self.tmp, f"rank{r}.log")
                     for r in range(world)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), case, str(r),
                     str(world), self.tmp], env=env, stdout=out,
                    stderr=subprocess.STDOUT))

    def results(self, timeout: float) -> list:
        import pytest
        import torch

        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.wait()
            pytest.fail(f"{self.case} on {len(self.procs)} ranks did not "
                        f"finish in {timeout} s (a deadlock?)")
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                with open(self.logs[r]) as f:
                    pytest.fail(f"{self.case} rank {r} failed:\n"
                                f"{f.read()[-6000:]}")
        results = []
        for r in range(len(self.procs)):
            # a rank's state dicts take hundreds of MB: read, then delete
            path = os.path.join(self.tmp, f"rank{r}.pt")
            results.append(torch.load(path, weights_only=False))
            os.remove(path)
        return results


# ----------------------------------------------------------- rank cases


def case_bn(rank, world, tmp, **_):
    """GlobalBatchNorm on this rank's rows ``rank::world`` of each input in
    ``bn_inputs.pt``: outputs, the input and weight gradients of
    ``sum(y * r)`` and the updated running statistics."""
    import torch

    from selavi_tpu_torch.models.common import flax_batch_norm

    out = {}
    for key, (x, w, b, r) in torch.load(os.path.join(tmp, "bn_inputs.pt"),
                                        weights_only=False).items():
        x = x[rank::world].clone().requires_grad_(True)
        w = w.clone().requires_grad_(True)
        b = b.clone().requires_grad_(True)
        rm = torch.zeros(x.shape[1], dtype=x.dtype)
        rv = torch.ones(x.shape[1], dtype=x.dtype)
        y = flax_batch_norm(x, w, b, rm, rv, training=True)
        (y * r[rank::world]).sum().backward()
        out[key] = {"y": y.detach(), "dx": x.grad, "dw": w.grad,
                    "db": b.grad, "rm": rm, "rv": rv}
    return out


def case_step(rank, world, tmp, dtype, use_mlp, colorjitter, **_):
    """One DDP train step of the port on this rank's rows of the global
    batch in ``step_inputs.npz``, from the numpy weights of
    ``step_weights.pt``; returns the state after it and the local loss."""
    import numpy as np
    import torch

    from selavi_tpu_torch.models.av_model import load_model
    from selavi_tpu_torch.models.convert import load_jax_variables
    from selavi_tpu_torch.parallel.mesh import data_parallel
    from selavi_tpu_torch.train.optim import make_optimizer, set_lr
    from selavi_tpu_torch.train.step import make_train_step

    data = np.load(os.path.join(tmp, "step_inputs.npz"))
    params, bs = torch.load(os.path.join(tmp, "step_weights.pt"),
                            weights_only=False)
    tdtype = getattr(torch, dtype)
    model = load_model(headcount=int(data["heads"]),
                       num_classes=int(data["k"]), use_mlp=use_mlp,
                       device="cpu")
    load_jax_variables(model, params, bs)
    model = model.to(tdtype)
    opt = make_optimizer(model, float(data["lr"]), float(data["wd"]))
    set_lr(opt, float(data["lr"]))
    ddp = data_parallel(model, torch.device("cpu"))
    step = make_train_step(ddp, opt, colorjitter=colorjitter,
                           compute_dtype=tdtype, shard=(rank, world))
    rows = slice(rank, None, world)
    metrics = step({"video": torch.from_numpy(data["video"][rows]),
                    "audio": torch.from_numpy(data["audio"][rows])},
                   torch.from_numpy(data["labels"][rows]).long(),
                   torch.Generator().manual_seed(int(data["seed"])))
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "loss": float(metrics["loss"])}


def _fingerprint(tensors) -> dict:
    """An fp64 (sum, sum of squares) of each tensor: equal bits give equal
    fingerprints."""
    return {k: (float(v.double().sum()), float(v.double().square().sum()))
            for k, v in tensors.items()}


def _max_diff(got, ref) -> float:
    """The largest ``|got - ref| / (max |ref| + |ref|)`` in fp64: within
    ``rtol`` it is ``tests/test_torch_dist.py::_close(got, ref, rtol)``."""
    got, ref = got.double(), ref.double()
    scale = max(float(ref.abs().max()), 1e-12)
    return float(((got - ref).abs() / (scale + ref.abs())).max())


def _distance(ref32, ref64) -> dict:
    """``_max_diff`` of each tensor of an fp32 step's ``(before, full,
    momentum)`` from the fp64 step's, keyed as ``vs_m1``."""
    before32, full32, momentum32 = ref32
    before64, full64, momentum64 = ref64
    out = {}
    for key, value in full64.items():
        out[key] = (_max_diff(full32[key], value) if "running" in key
                    else _max_diff(full32[key] - before32[key],
                                   value - before64[key]))
    for key, value in momentum64.items():
        out[f"momentum:{key}"] = _max_diff(momentum32[key], value)
    return out


def case_grid_steps(rank, world, tmp, configs, **_):
    """One train step of the port on this rank's rows of the global batch
    in ``step_inputs_{inputs}.npz`` for each ``[name, model_axis, dtype,
    use_mlp, colorjitter, inputs]`` of ``configs``, from the numpy weights of
    ``step_weights_{mlp|linear}.pt``, each from the same weights. Returns,
    per config, the global loss, the heads this rank holds and its
    optimizer's momentum shapes and a fingerprint of its towers. Rank 0
    also takes the state in the one-process layout
    (``checkpoint.full_layout``) with the momentum by parameter name: for
    a config ``m2_x`` after ``m1_x`` it returns ``vs_m1``, each tensor's
    ``_max_diff`` from ``m1_x``'s (of the step's change for parameters, of
    the values for the BN statistics and the momentum), and for
    ``m2_float32`` after ``m1_float64`` also the distances of the fp32
    ``M = 1`` step (``fp32_error``) and of itself (``vs_fp64``) from the
    fp64 ``M = 1`` step;
    for any other config the state itself (``full``, ``momentum``)."""
    import numpy as np
    import torch

    from selavi_tpu_torch.models.av_model import load_model
    from selavi_tpu_torch.models.convert import load_jax_variables
    from selavi_tpu_torch.parallel import mesh
    from selavi_tpu_torch.train.checkpoint import full_layout
    from selavi_tpu_torch.train.optim import make_optimizer, set_lr
    from selavi_tpu_torch.train.step import make_train_step

    weights, kept, out = {}, {}, {}
    rows = slice(rank, None, world)
    for name, model_axis, dtype, use_mlp, colorjitter, inputs in configs:
        data = np.load(os.path.join(tmp, f"step_inputs_{inputs}.npz"))
        kind = "mlp" if use_mlp else "linear"
        if kind not in weights:
            weights[kind] = torch.load(
                os.path.join(tmp, f"step_weights_{kind}.pt"),
                weights_only=False)
        tdtype = getattr(torch, dtype)
        grid = mesh.make_grid(model_axis, int(data["heads"]))
        model = load_model(headcount=int(data["heads"]),
                           num_classes=int(data["k"]), use_mlp=use_mlp,
                           device="cpu", grid=grid)
        load_jax_variables(model, *weights[kind])
        model = model.to(tdtype)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model, float(data["lr"]), float(data["wd"]))
        set_lr(opt, float(data["lr"]))
        net = mesh.grid_parallel(model, grid, torch.device("cpu"))
        step = make_train_step(net, opt, colorjitter=colorjitter,
                               compute_dtype=tdtype, shard=(rank, world),
                               grid=grid)
        metrics = step({"video": torch.from_numpy(data["video"][rows]),
                        "audio": torch.from_numpy(data["audio"][rows])},
                       torch.from_numpy(data["labels"][rows]).long(),
                       torch.Generator().manual_seed(int(data["seed"])))
        params = dict(model.named_parameters())
        state = model.state_dict()
        result = out[name] = {
            "loss": float(grid.loss(metrics["loss"])),
            "heads": {k: v.clone() for k, v in state.items()
                      if k.startswith("heads_")},
            "moment_shapes": {
                n: tuple(opt.state[p]["momentum_buffer"].shape)
                for n, p in params.items() if n.startswith("heads_")},
            "towers": _fingerprint({k: v for k, v in state.items()
                                    if not k.startswith("heads_")}),
            "net": type(net).__name__,
        }
        if grid.data_index != 0:
            continue
        full, opt_state = full_layout(model, opt, grid)  # data row 0
        if rank != 0:
            continue
        names = list(params)
        momentum = {names[i]: s["momentum_buffer"]
                    for i, s in opt_state["state"].items()}
        ref = kept.get(name.replace("m2_", "m1_"))
        if name.startswith("m1_"):
            kept[name] = (before, full, momentum)
        elif ref is None:
            result.update(full=full, momentum=momentum)
        else:
            ref_before, ref_full, ref_momentum = ref
            diffs = {"keys": (sorted(full) == sorted(ref_full),
                              sorted(momentum) == sorted(ref_momentum))}
            for key, value in ref_full.items():
                diffs[key] = (_max_diff(full[key], value) if "running" in key
                              else _max_diff(full[key] - ref_before[key],
                                             value - ref_before[key]))
            for key, value in ref_momentum.items():
                diffs[f"momentum:{key}"] = _max_diff(momentum[key], value)
            result["vs_m1"] = diffs
            if name == "m2_float32" and "m1_float64" in kept:
                # both fp32 steps' distances from the fp64 M = 1 step
                result["fp32_error"] = _distance(ref, kept["m1_float64"])
                result["vs_fp64"] = _distance((ref_before, full, momentum),
                                              kept["m1_float64"])
    return out


def _tiny_args(extra):
    from selavi_tpu_torch.config import parse_arguments

    return parse_arguments().parse_args(TINY.split() + extra.split())


def case_lr(rank, world, tmp, extra, stop_rank, stop_step, **_):
    """Two Trainers on one dump path with scripted steps that record the LR
    they see: the first is preempted (SIGUSR1 on ``stop_rank`` after step
    ``stop_step``), the second resumes. Returns [(step, lr)] of each."""
    import torch

    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.parallel import dist
    from selavi_tpu_torch.train.loop import Trainer

    args = _tiny_args(extra + f" --dump_path {tmp}/dump")
    runs = []
    for _ in range(2):
        dist.init_signal_handler()  # a restarted process: no flag yet
        trainer = Trainer(args, build_dataset(args), device="cpu")
        seen = []

        def train_step(batch, labels, gen, trainer=trainer, seen=seen):
            seen.append((trainer.step,
                         trainer.optimizer.param_groups[0]["lr"]))
            if rank == stop_rank and trainer.step == stop_step:
                os.kill(os.getpid(), signal.SIGUSR1)
            return {"loss": torch.tensor(1.0)}

        trainer.train_step = train_step
        trainer.maybe_cluster = lambda iteration: False
        trainer.warmup_batchnorm = lambda: None
        code = None
        try:
            trainer.fit()
        except SystemExit as e:
            code = e.code
        runs.append({"lrs": seen, "exit": code,
                     "batches_per_epoch": trainer.batches_per_epoch})
    return runs


def _run_cli(argv, stop_step=None):
    """``cli.main.main(argv, device="cpu")`` with a Trainer that records
    itself and the ranks' checkpoint writes and, with ``stop_step``, gets
    SIGUSR1 after that many optimizer steps; returns (exit code, Trainer,
    epochs written)."""
    from selavi_tpu_torch.cli import main as cli_main
    from selavi_tpu_torch.train import loop

    built, written = [], []
    save = loop.save_checkpoint

    def recorded_save(*args, **kwargs):
        written.append(args[4])
        return save(*args, **kwargs)

    class Recorded(loop.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)
            if stop_step is not None:
                inner = self.train_step

                def train_step(*a):
                    out = inner(*a)
                    if self.step + 1 == stop_step:
                        os.kill(os.getpid(), signal.SIGUSR1)
                    return out

                self.train_step = train_step

    cli_main.Trainer = Recorded
    loop.save_checkpoint = recorded_save
    code = None
    try:
        cli_main.main(argv, device="cpu")
    except SystemExit as e:
        code = e.code
    finally:
        cli_main.Trainer = loop.Trainer
        loop.save_checkpoint = save
    return code, built[0], written


def case_cli(rank, world, tmp, extra, stop_rank=None, stop_step=None, **_):
    """The CLI over TINY on this rank; returns the state every rank must
    share after it (labels, head parameters, BN buffers), its history,
    exit code and checkpoint writes."""
    argv = (TINY + " " + extra + f" --dump_path {tmp}/dump").split()
    code, trainer, written = _run_cli(
        argv, stop_step if rank == stop_rank else None)
    state = trainer.model.state_dict()
    return {
        "exit": code,
        "written": written,
        "labels": trainer.sl_state.selflabels.copy(),
        "heads": {k: v.clone() for k, v in state.items()
                  if k.startswith("heads_")},
        "buffers": {k: v.clone() for k, v in state.items()
                    if "running" in k},
        "params": {k: v.clone() for k, v in trainer.model.named_parameters()},
        "history": trainer.history,
        "step": trainer.step,
        "net": type(trainer.net).__name__,
    }


def case_eval(rank, world, tmp, **_):
    """get_clusters, video_retrieval (v-v) and finetune_video --test_only
    on this rank; returns the retrieval's and the finetune's results (the
    dump is the file ``{tmp}/ps.pkl``)."""
    from selavi_tpu_torch.cli import finetune_video, get_clusters
    from selavi_tpu_torch.cli import video_retrieval

    out = {}
    get_clusters.main(EVAL_ARGS["get_clusters"].split() + [
        "--output_path", os.path.join(tmp, "ps.pkl")], device="cpu")
    out["retrieval"] = video_retrieval.main(
        EVAL_ARGS["retrieval"].split(), device="cpu")
    result = finetune_video.main(EVAL_ARGS["finetune"].split() + [
        "--output_dir", os.path.join(tmp, "ft")], device="cpu")
    out["finetune"] = {"vid1": result["acc1"][0], "vid5": result["acc5"][0]}
    return out


def finetune_step(rank, world, tmp):
    """One fp64 finetune train step (``use_bn``, ``use_dropout``,
    ``use_l2_norm``) on this rank's rows of ``ft_inputs.npz``, under DDP
    when there is a group; returns the state before and after it and the
    loss."""
    import numpy as np
    import torch

    from selavi_tpu_torch.eval import finetune as ft
    from selavi_tpu_torch.parallel.mesh import data_parallel

    data = np.load(os.path.join(tmp, "ft_inputs.npz"))
    flags = dict(use_dropout=True, use_bn=True, use_l2_norm=True)
    model = ft.FinetuneModel(4, generator=torch.Generator().manual_seed(0),
                             **flags).to(torch.float64)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = ft.FinetuneConfig(num_classes=4, head_lr=0.1, base_lr=0.05,
                            **flags)
    opt = ft.make_finetune_optimizer(cfg, model)
    ft.set_finetune_lr(opt, ft.lr_factor_table(cfg), 0, 1)
    train_model = model if world == 1 else data_parallel(
        model, torch.device("cpu"))
    train_step, _, _ = ft.make_finetune_steps(
        model, opt, torch.float64, train_model=train_model,
        shard=(rank, world))
    rows = slice(rank, None, world)
    loss, _ = train_step(torch.from_numpy(data["video"][rows]),
                         torch.from_numpy(data["labels"][rows]),
                         torch.Generator().manual_seed(5))
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "before": before, "loss": float(loss)}


def case_ft_step(rank, world, tmp, **_):
    return finetune_step(rank, world, tmp)


# tests/mp_eval_worker.py's recipes, with sample counts that no rank count
# divides, so the ranks' strides end in wrap-padding
EVAL_ARGS = {
    "get_clusters": (
        "--ds_name synthetic --num_data_samples 23 --weights_path None "
        "--headcount 2 --mlp_dim 8 --num_frames 4 --train_crop_size 32 "
        "--aud_sample_rate 24000 --aud_spec_type 1 --batch_size 4 "
        "--workers 0"),
    "retrieval": (
        "--dataset synthetic --task v-v --num_data_samples 11 --clip_len 16 "
        "--batch_size 2 --workers 0 --headcount 2 --num_clusters 8 "
        "--aud_sample_rate 24000 --aud_spec_type 1"),
    "finetune": (
        "--dataset synthetic --num_data_samples 15 --clip_len 8 "
        "--batch_size 2 --workers 0 --epochs 1 --fold 1 --test_only true "
        "--weights_path None --compute_dtype float32"),
}

def case_grid_cli(rank, world, tmp, extra, **_):
    """One BN-warmup batch of a Trainer over TINY plus ``extra`` at
    ``--model_axis`` 1 and 2 (``warmup``: each running statistic's
    ``_max_diff`` between them, the heads gathered); the CLI over the same
    at ``--model_axis`` 1 and then 2, each on its own dump path; then each
    file restored into a Trainer at the other ``M`` and written again
    under ``{tmp}/cross{M}``. Returns, per ``M``, what every rank must
    share after the run (labels, marginals, host RNG state, the audio
    permutations, SK metrics), the heads it solved and holds, and whether
    the crossed restore equals the file."""
    import numpy as np
    import torch

    from selavi_tpu_torch.models.heads import HeadStack
    from selavi_tpu_torch.selflabel import engine
    from selavi_tpu_torch.train.checkpoint import (
        CKPT_NAME,
        restore_checkpoint,
        wait_for_pending_checkpoint,
    )
    from selavi_tpu_torch.train.loop import Trainer

    perms, solved = [], []
    permute, solve = HeadStack.permute_output, engine.sinkhorn_knopp

    def recorded_permute(stack, head, perm):
        perms.append((head, [int(i) for i in perm]))
        return permute(stack, head, perm)

    def recorded_solve(m, *a, **kw):
        solved.append(m.shape)
        return solve(m, *a, **kw)

    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.train.checkpoint import full_layout

    # the BN warmup at each M: the running statistics, heads gathered
    warm = {}
    for m in (1, 2):
        args = _tiny_args(f"{extra} --model_axis {m} --dump_path "
                          f"{tmp}/warm{m}")
        trainer = Trainer(args, build_dataset(args), device="cpu")
        trainer.warmup_batchnorm(batches=1)
        warm[m] = {k: v for k, v in full_layout(
            trainer.model, trainer.optimizer, trainer.grid)[0].items()
            if "running" in k}
        del trainer
    out = {"warmup": {k: _max_diff(warm[2][k], v)
                      for k, v in warm[1].items()}}
    HeadStack.permute_output = recorded_permute
    engine.sinkhorn_knopp = recorded_solve
    try:
        for m in (1, 2):
            perms.clear()
            solved.clear()
            argv = (f"{TINY} {extra} --model_axis {m} --dump_path "
                    f"{tmp}/dump{m}").split()
            code, trainer, _ = _run_cli(argv)
            wait_for_pending_checkpoint()
            if rank == 0:  # the epoch's archived copy: compared nowhere
                shutil.rmtree(f"{tmp}/dump{m}/checkpoints")
            state = trainer.model.state_dict()
            out[m] = {
                "exit": code,
                "labels": trainer.sl_state.selflabels.copy(),
                "dists": trainer.sl_state.marginals.dists.copy(),
                "rng": trainer.np_rng.bit_generator.state,
                "perms": list(perms),
                "solves": len(solved),
                "sk": [{k: v for k, v in h.items() if k != "sk_time"}
                       for h in trainer.history if "sk_cost" in h],
                "head_shapes": {k: tuple(v.shape) for k, v in state.items()
                                if k.startswith("heads_")},
                "net": type(trainer.net).__name__,
            }
            del trainer
        # each file into a Trainer at the other M, and written again
        for m, other in ((1, 2), (2, 1)):
            args = _tiny_args(f"{extra} --model_axis {other} --dump_path "
                              f"{tmp}/cross{other}")
            trainer = Trainer(args, build_dataset(args), device="cpu")
            path = os.path.join(tmp, f"dump{m}", CKPT_NAME)
            sl, epoch, step = restore_checkpoint(
                path, trainer.model, trainer.optimizer, trainer.sl_state)
            trainer.sl_state, trainer.step = sl, step
            saved = torch.load(path, map_location="cpu", weights_only=True)
            first, count = (trainer.grid.heads(2) if trainer.grid
                            else (0, 2))
            own = slice(first, first + count)
            equal = all(
                torch.equal(v, saved["model"][k][own]
                            if k.startswith("heads_") else saved["model"][k])
                for k, v in trainer.model.state_dict().items())
            trainer.checkpoint(epoch - 1)
            wait_for_pending_checkpoint()
            out[f"cross{other}"] = {"restored_equal": equal,
                                    "epoch": epoch, "step": step}
            del trainer
    finally:
        HeadStack.permute_output = permute
        engine.sinkhorn_knopp = solve
    return out


CASES = {"bn": case_bn, "step": case_step, "lr": case_lr, "cli": case_cli,
         "eval": case_eval, "ft_step": case_ft_step,
         "grid_steps": case_grid_steps, "grid_cli": case_grid_cli}


def main():
    case, rank, world, tmp = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    import torch
    import torch.distributed as tdist

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "params.json")) as f:
        params = json.load(f)
    if world > 1:  # one rank runs without a group: the plain path
        tdist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                 rank=rank, world_size=world)
    result = CASES[case](rank, world, tmp, **params)
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    if tdist.is_initialized():
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()

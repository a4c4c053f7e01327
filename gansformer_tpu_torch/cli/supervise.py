"""Run the port's training under the run supervisor (the port's copy of
``gansformer_tpu/cli/supervise.py``).

Everything after ``--`` goes to ``python -m gansformer_tpu_torch.cli.train``
unchanged; the supervisor owns the run dir, passes it to every (re)start
as ``--run-dir``, adds ``--resume`` once ``<run dir>/checkpoints``
exists, classifies every exit (clean, crash, preemption, hang, the typed
data exits) and restarts under bounded exponential backoff until the run
completes or the restart budget runs out.  ``--fault`` specs
(``supervise/faults.py``) are validated here, before the launch, and
reach the child through ``GANSFORMER_TPU_FAULTS``, with the fired ledger
at ``<run dir>/faults_fired.jsonl``.

This process imports neither torch nor CUDA: it must not claim the card
its child needs.

Examples
--------
  # an ffhq256 run that survives preemptions and crashes:
  python -m gansformer_tpu_torch.cli.supervise --results-dir results -- \\
      --preset ffhq256-duplex --data-path /data/ffhq --batch-size 32

  # prove recovery: one SIGKILL at the tick boundary after step 4000
  python -m gansformer_tpu_torch.cli.supervise --run-dir results/r0 \\
      --fault sigkill@tick:step=4000 -- \\
      --preset ffhq256-duplex --data-source synthetic --total-kimg 8

Exit codes: 0 = training completed; 75 = the supervisor itself was
preempted (re-arm later); 1 = restart budget exhausted or a
non-retryable exit.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Supervised (auto-resuming, fault-classified) "
                    "training",
        epilog="arguments after -- are forwarded to "
               "gansformer_tpu_torch.cli.train")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--desc", default="supervised",
                   help="run dir description suffix (numbered-dir mode)")
    p.add_argument("--run-dir", default=None,
                   help="pin the run dir (default: allocate a numbered "
                        "dir under --results-dir)")
    p.add_argument("--max-restarts", type=int, default=8,
                   help="restart budget before giving up (default 8)")
    p.add_argument("--backoff-base", type=float, default=2.0,
                   help="base of the bounded exponential restart "
                        "backoff, seconds")
    p.add_argument("--backoff-max", type=float, default=120.0)
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="child liveness poll cadence, seconds")
    p.add_argument("--heartbeat-max-age", type=float, default=300.0,
                   help="a child that stops beating for this long is "
                        "declared hung and killed")
    p.add_argument("--startup-grace", type=float, default=1800.0,
                   help="grace before the FIRST heartbeat (compiles "
                        "happen before it)")
    p.add_argument("--hang-grace", type=float, default=15.0,
                   help="SIGTERM→SIGKILL window once a hang verdict "
                        "lands")
    p.add_argument("--preempt-grace", type=float, default=30.0,
                   help="grace the child gets for its final checkpoint "
                        "on SIGTERM (exported as "
                        "GANSFORMER_TPU_PREEMPT_GRACE_S)")
    p.add_argument("--max-step-skew", type=int, default=None,
                   help="multi-process: step spread beyond this is a "
                        "hang verdict (straggler)")
    p.add_argument("--fault", action="append", default=[],
                   metavar="SPEC",
                   help="arm a fault-injection spec in the child, e.g. "
                        "sigkill@ckpt_mid_write:step=4000 (repeatable; "
                        "each fires once per run dir — see "
                        "supervise/faults.py)")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="-- followed by the train CLI's arguments")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]

    from gansformer_tpu_torch.supervise import faults
    from gansformer_tpu_torch.supervise.supervisor import (
        SupervisorConfig, supervise)
    from gansformer_tpu_torch.utils.logging import create_run_dir

    run_dir = args.run_dir or create_run_dir(args.results_dir, args.desc)
    child_env = {}
    if args.fault:
        # Validate the specs HERE (a typo must fail the launch, not
        # silently never fire in the child), then hand them over by env.
        faults.parse_specs(",".join(args.fault))
        child_env[faults.ENV_SPEC] = ",".join(args.fault)
        child_env[faults.ENV_LEDGER] = os.path.join(
            run_dir, "faults_fired.jsonl")

    def build_argv(resume: bool, restart_index: int):
        argv = [sys.executable, "-m", "gansformer_tpu_torch.cli.train",
                *train_args, "--run-dir", run_dir]
        if resume:
            argv.append("--resume")
        return argv

    cfg = SupervisorConfig(
        max_restarts=args.max_restarts,
        backoff_base_s=args.backoff_base,
        backoff_max_s=args.backoff_max,
        poll_interval_s=args.poll_interval,
        heartbeat_max_age_s=args.heartbeat_max_age,
        startup_grace_s=args.startup_grace,
        hang_kill_grace_s=args.hang_grace,
        preempt_grace_s=args.preempt_grace,
        max_step_skew=args.max_step_skew)
    result = supervise(build_argv, run_dir, cfg, child_env=child_env)
    sys.exit(result["exit_code"])


if __name__ == "__main__":
    main()

"""The port's lint tool: the twin of ``tools/repro_lint.py``.

Default mode runs the :mod:`repro_torch.analysis.lint` rule engine over
``src/repro_torch`` (plus the repo-level registry-closure rule) and
prints one ``path:line: rule: message`` line per violation — exit 1 if
any.

``--smoke-races`` instead exercises the *dynamic* passes end to end on
the CPU: a small ``hnp`` workload on a 4-device modeled cluster with
pipelined staging + cross-wave prefetch under ``validate=True`` (the
graph verifier checks every forced graph before dispatch), its
``LaunchTicket`` streams through the happens-before race detector; then
the streaming server over a seeded bursty trace (its full ticket log and
every slot-refill edge); then a seeded Zipf-skewed expert-routing
workload (every dynamic-placement migration edge).  A clean tree gives
zero violations from all passes.

Run:
    python tools/repro_torch_lint.py [paths...]
    python tools/repro_torch_lint.py --smoke-races
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"),
)

from repro_torch.analysis.base import format_violations  # noqa: E402

FLIGHT_DUMP = "flight_dump.json"


def _dump_flight(violations) -> None:
    """A red dynamic-pass run ships its own repro trace: freeze the obs
    flight recorder's bounded ticket/span window next to the violations."""
    from repro_torch.obs import flight

    path = flight.dump(FLIGHT_DUMP, violations)
    print(f"repro-torch-lint: flight recorder window dumped to {path}",
          file=sys.stderr)


def _report(violations, what: str) -> int:
    print(format_violations(violations))
    _dump_flight(violations)
    print(f"repro-torch-lint --smoke-races: {len(violations)} violation(s) "
          f"over {what}", file=sys.stderr)
    return 1


def run_rules(paths) -> int:
    from repro_torch.analysis.lint import RULES, repo_root, run_lint

    root = repo_root()
    violations = run_lint(root, paths=[pathlib.Path(p) for p in paths] or None)
    if violations:
        print(format_violations(violations))
        print(f"repro-torch-lint: {len(violations)} violation(s)",
              file=sys.stderr)
        return 1
    nfiles = sum(
        1 for p in (paths or [root / "src" / "repro_torch"])
        for _ in pathlib.Path(p).rglob("*.py")
    )
    print(f"repro-torch-lint: clean ({nfiles} files, {len(RULES)} rules + "
          "registry closure)")
    return 0


def run_smoke_races() -> int:
    import numpy as np

    import repro_torch.hnp as hnp
    from repro_torch.analysis.races import check_ticket_streams, ticket_streams
    from repro_torch.core import engine, offload_policy

    rng = np.random.default_rng(0)
    x = np.asarray(rng.normal(size=(256, 192)), np.float32)
    w1 = np.asarray(rng.normal(size=(192, 256)), np.float32)
    b1 = np.asarray(rng.normal(size=(256,)), np.float32)
    w2 = np.asarray(rng.normal(size=(256, 128)), np.float32)
    w3 = np.asarray(rng.normal(size=(256, 128)), np.float32)

    engine().reset()
    with offload_policy(mode="device", num_devices=4, scheduler="cost-aware",
                        prefetch_staging=True):
        # validate=True: pass 1 verifies each forced graph pre-dispatch
        with hnp.offload_region("lint-smoke", validate=True):
            h = hnp.tanh(hnp.linear(hnp.array(x, device="cpu"), w1, b1))
            a = h @ w2                  # independent same-shape GEMMs: batch
            b = h @ w3
            hnp.asnumpy(a + b)
            hnp.asnumpy(hnp.relu(h) @ w2)   # second wave: prefetch + d2d
        streams = ticket_streams()
        violations = check_ticket_streams(streams)

    ntickets = sum(len(ts) for ts in streams.values())
    if violations:
        return _report(violations, f"{ntickets} tickets")
    kinds = sorted({t.kind for ts in streams.values() for t in ts})
    print(
        f"repro-torch-lint --smoke-races: clean ({ntickets} tickets on "
        f"{len(streams)} devices, kinds: {'/'.join(kinds)}; graph verifier "
        "ran on every forced graph)"
    )
    return run_smoke_stream_races()


def run_smoke_stream_races() -> int:
    """The streaming engine's full ticket log through the happens-before
    checker and every ``SlotRefill`` edge through
    ``race/slot-refill-before-complete``."""
    from repro_torch.analysis.races import check_slot_refills, check_ticket_streams
    from repro_torch.launch.streaming import bursty_trace, serve_stream

    trace = bursty_trace(120.0, 0.75, seed=0)
    report = serve_stream("yi-6b", trace)
    violations = check_ticket_streams(report.ticket_log)
    violations += check_slot_refills(report.slot_refills)
    ntickets = sum(len(ts) for ts in report.ticket_log.values())
    if violations:
        return _report(violations, f"the streaming-serve workload "
                       f"({ntickets} tickets)")
    print(
        f"repro-torch-lint --smoke-races: streaming serve clean ({ntickets} "
        f"tickets, {len(report.slot_refills)} slot-refill edges, "
        f"{report.completed}/{report.admitted} requests completed)"
    )
    return run_smoke_expert_races()


def run_smoke_expert_races() -> int:
    """A Zipf-skewed expert-routing workload under the dynamic placement
    policy: per-lane ticket streams for happens-before and every migration
    edge for ``race/expert-migrate-before-drain``."""
    from repro_torch.analysis.races import (
        check_expert_migrations,
        check_ticket_streams,
    )
    from repro_torch.core.placement import run_skewed_workload

    result = run_skewed_workload(zipf_s=1.2, seed=0, dynamic=True)
    violations = check_ticket_streams(result.ticket_streams)
    violations += check_expert_migrations(result.migration_edges)
    ntickets = sum(len(ts) for ts in result.ticket_streams.values())
    if violations:
        return _report(violations, f"the skewed expert-placement workload "
                       f"({ntickets} tickets)")
    print(
        f"repro-torch-lint --smoke-races: expert placement clean ({ntickets} "
        f"tickets, {len(result.migration_edges)} migration edges, "
        f"{result.migrations} migrations / {result.replications} "
        "replications under Zipf s=1.2)"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument(
        "--smoke-races", action="store_true",
        help="run the graph verifier + race detector over a smoke workload",
    )
    args = ap.parse_args(argv)
    if args.smoke_races:
        return run_smoke_races()
    return run_rules(args.paths)


if __name__ == "__main__":
    sys.exit(main())

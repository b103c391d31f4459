"""rttest CLI for the port: the counterpart of visual_testing/rttest/main.py.

    python -m tpu_raytracing_torch.rttest [cuda|cpu] [--scenes a,b] [--json]
        [--no-perf | --perf-only | --perf-baseline | --perf-history SCENE]
        [--perf-threshold P] [--tests-file F] [--references DIR] [--out DIR]
        -- <renderer args>
    python -m tpu_raytracing_torch.rttest digest [--source DIR]
        [--commit HASH] [--wall NAME=SECONDS ...] [--references DIR]

Renders every row of the JAX harness's suite (visual_testing/tests/
tests.toml, read by path) through `python -m tpu_raytracing_torch.cli` on
the card (`cuda`, the default) or the CPU, and holds each output against
the JAX package's CPU reference with the JAX harness's cross-backend
statistical gate and thresholds (diff.py), on both backends: the port is
never its own reference, so it has no bless and no exact-match gate.
`digest` makes the references from the JAX package's CPU renders
(digest.py). Outputs, the perf history and the perf baseline go to
tpu_raytracing_torch/rttest/out/ (ignored by git) or --out.

Exit codes: 0 = all pass, 1 = visual failures, rows without a reference
or perf regressions, 2 = renderer errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import perf
from .digest import EXTRA_ROWS, References, git_head, make_digest, row_args
from .runner import REPO, run_tests
from .test_spec import load_test_suite

HERE = Path(__file__).resolve().parent
SUITE = REPO / "visual_testing" / "tests" / "tests.toml"
# scene paths of the suite resolve under the JAX harness's directory, as
# there
SCENE_BASE = REPO / "visual_testing"
REFERENCES = HERE / "references"
OUT = HERE / "out"


def digest_main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="rttest digest",
        description="Digest the JAX package's CPU renders into the port's "
        "references")
    parser.add_argument("--source", type=Path,
                        default=SCENE_BASE / "references",
                        help="the JAX harness's blessed EXRs (default "
                        "visual_testing/references)")
    parser.add_argument("--commit", help="the JAX commit that rendered them "
                        "(default: git HEAD)")
    parser.add_argument("--wall", action="append", default=[],
                        metavar="NAME=SECONDS",
                        help="a row's CPU render wall seconds")
    parser.add_argument("--references", type=Path, default=REFERENCES,
                        help="where digest.json and the AOV EXRs go")
    parser.add_argument("--tests-file", type=Path, default=SUITE)
    args = parser.parse_args(argv)
    rows = {s.name: row_args(s, SCENE_BASE)
            for s in load_test_suite(args.tests_file)
            if s.scene_path is None or (SCENE_BASE / s.scene_path).exists()}
    rows.update(EXTRA_ROWS)
    wall = {k: float(v) for k, v in (w.split("=", 1) for w in args.wall)}
    make_digest(rows, args.source, args.references,
                args.commit or git_head(REPO), wall)
    print(f"digested {len(rows)} rows into {args.references}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["digest"]:
        return digest_main(argv[1:])
    if "--" in argv:
        split = argv.index("--")
        our_args, renderer_args = argv[:split], argv[split + 1:]
    else:
        our_args, renderer_args = argv, []

    parser = argparse.ArgumentParser(
        prog="rttest",
        description="Statistical-gate regression testing of the PyTorch port "
        "against the JAX package's CPU references",
    )
    parser.add_argument(
        "backend", nargs="?", choices=["cuda", "cpu"], default="cuda",
        help="the port's CLI backend (default cuda)",
    )
    parser.add_argument("--scenes", help="Comma-separated list of scenes (default: all)")
    parser.add_argument("--json", action="store_true", help="JSON results output")
    parser.add_argument("--no-perf", action="store_true", help="Disable timing capture")
    parser.add_argument("--perf-only", action="store_true", help="Skip visual comparison")
    parser.add_argument("--perf-baseline", action="store_true", help="Bless current timings as baseline")
    parser.add_argument("--perf-history", metavar="SCENE", help="Print timing history for a scene and exit")
    parser.add_argument("--perf-threshold", type=float, default=10.0, help="Regression threshold %% (default 10)")
    parser.add_argument("--tests-file", type=Path, default=SUITE,
                        help="TOML test spec (default visual_testing/tests/tests.toml)")
    parser.add_argument("--references", type=Path, default=REFERENCES,
                        help="reference directory (default the committed "
                        "digest of the JAX package's CPU renders)")
    parser.add_argument("--out", type=Path, default=OUT,
                        help="outputs, perf history and baseline")
    args = parser.parse_args(our_args)

    history = perf.PerfHistory(args.out / "perf_history.jsonl")
    baseline = perf.PerfBaseline(args.out / "perf_baseline.json")

    if args.perf_history:
        for r in history.records_for(args.perf_history):
            print(json.dumps(r.to_dict()))
        return 0

    specs = load_test_suite(args.tests_file)
    if args.scenes:
        wanted = {s.strip() for s in args.scenes.split(",")}
        unknown = wanted - {s.name for s in specs}
        if unknown:
            print(f"error: unknown scenes: {sorted(unknown)}", file=sys.stderr)
            return 2
        specs = [s for s in specs if s.name in wanted]

    print(f"running {len(specs)} tests (backend={args.backend}, "
          f"statistical gate against {args.references})")
    results = run_tests(
        specs, args.out / "outputs", References(args.references),
        renderer_args, args.backend, SCENE_BASE, visual=not args.perf_only,
    )

    # perf capture
    regressions = []
    if not args.no_perf:
        by_name = {s.name: s for s in specs}
        for res in results:
            if res.status == "ERROR":
                continue
            spec = by_name[res.name]
            rec = perf.make_record(
                res.name, res.render_time_seconds, renderer_args,
                args.backend, spec.settings.samples_per_pixel,
                spec.settings.light_samples,
            )
            history.append(rec)
            if args.perf_baseline:
                baseline.set(rec)
            else:
                reg = baseline.check_regression(rec, args.perf_threshold)
                if reg:
                    regressions.append(reg)
        if args.perf_baseline:
            baseline.save()
            print(f"blessed perf baseline for {len(results)} scenes")

    n_error = sum(r.status == "ERROR" for r in results)
    n_fail = sum(r.status == "FAIL" for r in results)
    n_new = sum(r.status == "NEW" for r in results)
    n_pass = sum(r.status == "PASS" for r in results)

    if args.json:
        print(
            json.dumps(
                {
                    "results": [r.to_dict() for r in results],
                    "regressions": regressions,
                    "summary": {
                        "pass": n_pass, "fail": n_fail, "new": n_new,
                        "error": n_error,
                    },
                }
            )
        )
    else:
        print(
            f"\n{n_pass} passed, {n_fail} failed, {n_new} new, {n_error} errors"
        )
        for reg in regressions:
            print(
                f"PERF REGRESSION {reg['scene']}: "
                f"{reg['baseline_seconds']:.2f}s -> {reg['current_seconds']:.2f}s "
                f"(+{reg['delta_pct']:.1f}%)"
            )
        if n_new:
            print("Rows without a reference: make them with "
                  "`python -m tpu_raytracing_torch.rttest digest`")

    if n_error:
        return 2
    if n_fail or n_new or regressions:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

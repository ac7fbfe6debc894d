"""Pass registry: every pass module exports ``PASS_ID`` and
``check(ctx) -> [Finding]``; tree-level passes additionally export
``facts(ctx) -> dict`` (collected per file, possibly in parallel) and
``tree_check(all_facts, repo_root, ctxs) -> [Finding]`` (run once in
the driver).  Adding a pass = adding a module here and listing it in
``ALL_PASSES``."""

from parsec_tpu_torch.tools.parseclint.passes import (
    assert_hazard, device_put, evloop_blocking, except_hygiene, hot_path,
    journal_schema, lock_discipline, mca_knobs, prom_metrics)

ALL_PASSES = (
    lock_discipline,
    evloop_blocking,
    hot_path,
    device_put,
    mca_knobs,
    prom_metrics,
    journal_schema,
    except_hygiene,
    assert_hazard,
)

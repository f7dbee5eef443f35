# ballista-lint: path=ballista_tpu_torch/executor/fixture_failure_exchange_bad.py
"""BAD: exchange chaos naming an unregistered site and computing
a site name — both evade the chaos registry, so an exchange chaos run could
not be reproduced (or even enumerated) from chaos.SITES."""


def probe_registry(chaos, stage_id, map_partition, piece, attempt):
    # unregistered site: "exchange.drop" was never added to chaos.SITES
    return chaos.should_inject(
        "exchange.drop",
        f"{stage_id}/{map_partition}/piece{piece}@a{attempt}",
    )


def evict_entry(chaos, tier, key):
    site = f"exchange.{tier}"
    # computed site name: the registry cannot see which site this arms
    return chaos.should_inject(site, key)

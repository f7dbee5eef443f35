# ballista-lint: path=ballista_tpu_torch/executor/fixture_failure_bad.py
"""BAD: anonymous fetch_failed (no lost location), unregistered chaos site,
computed site name, ad-hoc ChaosInjected raise."""

from ballista_tpu_torch.utils.chaos import ChaosInjected


def report_fetch_failure(status, exc):
    # missing map_executor_id + path: the scheduler can't recompute
    status.fetch_failed.error = str(exc)
    status.fetch_failed.executor_id = "me"


def poll(chaos, n):
    chaos.maybe_fail("poll.heartbeat", f"poll/{n}")  # unregistered site
    site = "rpc." + "call"
    if chaos.should_inject(site, "k"):  # computed site evades the registry
        raise ChaosInjected(site, "k")  # ad-hoc raise outside the injector

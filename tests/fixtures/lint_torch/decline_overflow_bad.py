# ballista-lint: path=ballista_tpu_torch/ops/fixture_overflow_bad.py
"""BAD: M:N join tier-overflow decline that vanishes silently — the
reasonless raise and the bare None make the overflow invisible to bench's
join-path counters."""


class UnsupportedOnDevice(Exception):
    pass


TIERS = (1, 4, 16, 64, 256)


def admit(max_mult):
    for tier in TIERS:
        if max_mult <= tier:
            return tier
    raise UnsupportedOnDevice()  # no reason: which shape overflowed?


def join(max_mult):
    try:
        return admit(max_mult)
    except UnsupportedOnDevice:
        return None  # silent decline: counters report nothing

"""Shared helpers of the observability tests: registry and metric-object
deltas, so a test reads what it caused without resetting either
package's process-global metrics registry."""


def _delta(now, base):
    """``now - base``; float deltas rounded to 9 places, since the same
    increments over different bases differ in the last bits."""
    d = now - base
    return round(d, 9) if isinstance(d, float) else d


class RegistryDelta:
    """A registry's flat `snapshot()` values relative to the snapshot taken
    when this object was made (0 for a key that appeared since)."""

    def __init__(self, registry):
        self.registry = registry
        self.base = registry.snapshot()

    def __getitem__(self, key: str):
        return _delta(self.registry.snapshot().get(key, 0), self.base.get(key, 0))

    def changed(self, prefixes=("",)) -> dict:
        """Every key under one of `prefixes` whose value moved, with its
        delta; histogram keys other than ``.count`` are left out (their
        means and quantiles carry wall times)."""
        now = self.registry.snapshot()
        out = {}
        for k, v in now.items():
            if not k.startswith(tuple(prefixes)):
                continue
            fam = k.split("{", 1)[0]
            if fam.endswith((".mean_s", ".p50_s", ".p99_s")):
                continue
            d = _delta(v, self.base.get(k, 0))
            if d:
                out[k] = d
        return out


def family_values(*families) -> dict:
    """``{"name{labels}": value}`` of metric family objects as they hold
    them now (a histogram's sample count). Read from the objects a module
    made at import: a test elsewhere in the process may have reset the
    registry they were made in, which leaves them out of its snapshot."""
    out = {}
    for fam in families:
        for key, child in fam._each():
            suffix = "" if key is None else "{%s}" % ",".join(
                f'{k}="{v}"' for k, v in zip(fam.labelnames, key))
            out[fam.name + suffix] = child.count if fam.kind == "histogram" else child._value
    return out


class ObjectDelta:
    """`family_values` of some family objects relative to their values
    when this object was made."""

    def __init__(self, *families):
        self.families = families
        self.base = family_values(*families)

    def changed(self) -> dict:
        return {k: d for k, v in family_values(*self.families).items()
                if (d := _delta(v, self.base.get(k, 0)))}


def admission_families(mod) -> tuple:
    """The metric families an admission module made at import."""
    return (mod._ADMITTED, mod._REJECTED, mod._THROTTLE_WAITS, mod._THROTTLE_WAIT_HIST, mod._POLICY_CHANGES)


class FakeClock:
    """A deterministic `time` stand-in: each `perf_counter()` /
    `monotonic()` read advances by `step` seconds."""

    def __init__(self, step: float = 0.001):
        self.t = 1000.0
        self.step = step

    def _tick(self) -> float:
        self.t += self.step
        return self.t

    perf_counter = monotonic = _tick

    def sleep(self, s: float) -> None:
        self.t += s


def swap_module_globals(monkeypatch, package: str, old, new) -> int:
    """Point every loaded module of `package` that holds `old` as a module
    global at `new` instead (monkeypatch undoes it); returns how many
    globals moved. This is how a test gives a package a fresh recorder or
    tracer without resetting the process-wide one."""
    import sys

    n = 0
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == package or name.startswith(package + ".")):
            continue
        for attr, val in list(vars(mod).items()):
            if val is old:
                monkeypatch.setattr(mod, attr, new)
                n += 1
    return n

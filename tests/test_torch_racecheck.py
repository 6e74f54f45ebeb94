"""The port's runtime race checker as a module-scope pytest fixture —
holds no tests.

The port test files that drive PS, shard or serve-fleet threads bind it
with ``_port_racecheck = racecheck_module()``: every port
``ParameterServer``, ``ServeRouter``, ``DecodeEngine``, ``KVFabric`` and
``FleetSupervisor`` built while the file's tests run gets tracked locks
and guarded shared containers
(``distkeras_tpu_torch.analysis.racecheck``), and the file fails at its
end on any unguarded concurrent write, lock-order cycle or
write-after-publish it recorded.  ``DKLINT_RACECHECK=0`` turns it off
(as it does the JAX package's fixture in ``tests/conftest.py``).
"""

import pytest


def racecheck_module():
    """A module-scope autouse fixture that runs the file under the port's
    ``racecheck.enabled()`` and fails on any violation."""

    @pytest.fixture(scope="module", autouse=True)
    def _port_racecheck():
        from distkeras_tpu_torch.analysis import racecheck
        if not racecheck.enabled_by_env():
            yield
            return
        with racecheck.enabled() as violations:
            try:
                yield
            finally:
                # snapshot before the context exit clears the scoped list
                found = list(violations)
        assert not found, (
            "port racecheck: unguarded concurrent write(s):\n" + "\n".join(
                f"  {v['dict']}[{v['key']!r}] via {v['op']} on thread "
                f"{v['thread']}\n{v['stack']}" for v in found))

    return _port_racecheck

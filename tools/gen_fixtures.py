"""Regenerate the frozen byte fixtures in tests/fixtures/.

Run ONLY when a byte-level behavior change is intended (and say so in the
commit): python tools/gen_fixtures.py. Forces the CPU platform (the device
fixtures pin CPU-jax bytes, which is what CI runs).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
import fixture_lib  # noqa: E402


def main() -> None:
    os.makedirs(fixture_lib.FIXTURE_DIR, exist_ok=True)
    for name, *_ in fixture_lib.FIXTURES:
        blobs = {b: fixture_lib.encode_fixture(name, b) for b in fixture_lib.BACKENDS}
        for backend, blob in blobs.items():
            path = fixture_lib.fixture_path(name, backend)
            with open(path, "wb") as f:
                f.write(blob)
            print(f"{os.path.basename(path):45s} {len(blob):6d} B")
        same = blobs["numpy"] == blobs["jax"]
        print(f"{name:45s} numpy==jax: {same}")


if __name__ == "__main__":
    main()

"""``world_of_one``: a gloo world of one rank in the test's own process,
on a ``FileStore`` in a temporary directory, and its ``("data",
"model")`` mesh of (1, 1) on the CPU; the group is destroyed after the
test.  The port's test files that run a sharder at one rank import it."""
import os
import tempfile

import pytest
import torch.distributed as dist


@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process, on a FileStore."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            from repro_torch.launch.mesh import make_mesh
            yield make_mesh((1, 1), ("data", "model"), "cpu")
        finally:
            dist.destroy_process_group()

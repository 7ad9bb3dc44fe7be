"""A ``tmp_path`` that is removed when its test ends.

The port's tests write checkpoints of full-width towers (a few hundred MB
each), and pytest keeps the temporary directories of its last three
sessions. A test module imports this fixture, which takes the place of the
built-in one there, so that a session leaves no checkpoints behind and the
disk holds at most those of the tests running at once:

    from _torch_tmp import tmp_path  # noqa: F401
"""

import shutil

import pytest


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)

"""What the port still refuses, and how: a data-parallel world that the
visible cards cannot hold raises, naming the count. (The one option no
module covers, ``--ckpt_backend orbax``, is refused by name in
``tests/test_torch_ckpt.py``, ``tests/test_torch_engine.py`` and
``tests/test_torch_refine.py``.)"""

import pytest

from nerfsr_torch import engine
from nerfsr_torch.config import default_options


def test_a_world_beyond_the_cards_raises_naming_the_count(monkeypatch):
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    opt = default_options("train", model="nerf", dataset_mode="llff",
                          mesh_devices=2)
    with pytest.raises(RuntimeError, match=r"--mesh_devices 2 .*1 card "
                                           "visible"):
        engine.train(opt)
    opt = default_options("train", model="nerf", dataset_mode="llff",
                          mesh_devices=2, num_processes=3, process_id=0)
    with pytest.raises(ValueError, match="--mesh_devices 2 with "
                                         "--num_processes 3"):
        engine.train(opt)

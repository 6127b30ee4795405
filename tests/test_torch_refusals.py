"""What the port still refuses, and how: each option that no module of
the port covers yet raises ``NotImplementedError`` naming its
``ROADMAP.md`` item (queue 1 item 6), from the system's constructor and
through the entry points; a data-parallel world that the visible cards
cannot hold raises, naming the count."""

import pytest

from nerfsr_torch import engine
from nerfsr_torch import train as train_entry
from nerfsr_torch.config import default_options
from nerfsr_torch.models import create_model
from nerfsr_torch.models.nerf_system import NeRFSystem


def test_neutex_mlp_refuses_naming_item_6(tmp_path):
    opt = default_options("train", model="nerf", dataset_mode="llff",
                          mlp_network="neutex_mlp", device="cpu",
                          checkpoints_dir=str(tmp_path))
    for build in (lambda: create_model(opt, device="cpu"),
                  lambda: NeRFSystem(opt, device="cpu"),
                  lambda: engine.train(opt)):
        with pytest.raises(NotImplementedError,
                           match=r"--mlp_network neutex_mlp .*item 6"):
            build()


def test_template_model_refuses_naming_item_6(tmp_path):
    """Both configs default ``--model`` to ``template``: a command line
    without ``--model`` names the item rather than a missing key."""
    opt = default_options("train", device="cpu")
    assert opt.model == "template"
    with pytest.raises(NotImplementedError,
                       match=r"--model template .*item 6"):
        create_model(opt, device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"--model template .*item 6"):
        train_entry.main(["--name", "t", "--dataset_root", str(tmp_path),
                          "--img_wh", "8", "8", "--device", "cpu",
                          "--checkpoints_dir", str(tmp_path)])


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

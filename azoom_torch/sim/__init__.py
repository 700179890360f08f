"""Scene simulation (counterpart of azoom.sim): synthetic sources
(``signals``), far-field and moving-source mixing (``farfield``,
``motion``), shoebox rooms (``room``, ``scene``), the reference's C++ RIR and
corpus engines (``native``, ``corpus_native``) and local corpora
(``datasets``). Generators take a ``torch.Generator`` where the reference
takes a JAX key."""

from azoom_torch.sim.farfield import make_scene, mix_far_field
from azoom_torch.sim.motion import (
    linear_trajectory,
    make_moving_room_scene,
    make_moving_scene,
    mix_far_field_moving,
    traj_block_count,
)
from azoom_torch.sim.signals import speech_like, speech_like_batch

__all__ = [
    "make_scene",
    "mix_far_field",
    "make_moving_scene",
    "make_moving_room_scene",
    "mix_far_field_moving",
    "linear_trajectory",
    "traj_block_count",
    "speech_like",
    "speech_like_batch",
]

# Frozen copy of marl_hideandseek_torch/models/__init__.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Policy building blocks: the PyTorch port of ``marl_hideandseek_tpu.models``
(LayerNorm, MLP, EntitySelfAttentionNet, the actor and critic heads, the
LSTM, the observation normalizers and the actor-critic composition), with
every parameter stacked on a leading policy axis (``models/layers.py``).
"""

from portbench.reference.frozen.models.layers import (
    MLP,
    DenseLayerCritic,
    DenseLayerDiscreteActor,
    DiscreteActionDistributions,
    DreamerV3Critic,
    EntitySelfAttentionNet,
    LayerNorm,
)
from portbench.reference.frozen.models.rnn import LSTM
from portbench.reference.frozen.models.normalizer import (
    ObservationsCaster,
    ObservationsEMANormalizer,
)
from portbench.reference.frozen.models.actor_critic import (
    ActorCritic,
    BackboneEncoder,
    BackboneSeparate,
    BackboneShared,
    Policy,
    RecurrentBackboneEncoder,
)

__all__ = [
    "LayerNorm", "MLP", "EntitySelfAttentionNet", "DenseLayerDiscreteActor",
    "DenseLayerCritic", "DreamerV3Critic", "DiscreteActionDistributions",
    "LSTM", "ObservationsEMANormalizer", "ObservationsCaster",
    "ActorCritic", "BackboneEncoder",
    "RecurrentBackboneEncoder", "BackboneShared", "BackboneSeparate",
    "Policy",
]

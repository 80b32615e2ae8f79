"""Policy building blocks: the PyTorch port of ``marl_hideandseek_tpu.models``
(LayerNorm, MLP, EntitySelfAttentionNet, the actor and critic heads, the
LSTM, the observation normalizers and the actor-critic composition), with
every parameter stacked on a leading policy axis (``models/layers.py``).
"""

from marl_hideandseek_torch.models.layers import (
    MLP,
    DenseLayerCritic,
    DenseLayerDiscreteActor,
    DiscreteActionDistributions,
    DreamerV3Critic,
    EntitySelfAttentionNet,
    LayerNorm,
)
from marl_hideandseek_torch.models.rnn import LSTM
from marl_hideandseek_torch.models.normalizer import (
    ObservationsCaster,
    ObservationsEMANormalizer,
)
from marl_hideandseek_torch.models.actor_critic import (
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

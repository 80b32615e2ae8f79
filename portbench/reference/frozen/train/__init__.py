# Frozen copy of marl_hideandseek_torch/train at commit fbfc592641d85df17e7487fd9f1855010c549ebb: the
# modules the reference needs (cfg, ppo, rollout). Do not edit.

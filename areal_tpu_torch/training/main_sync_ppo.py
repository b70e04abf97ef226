"""Sync-PPO entry point (reference ``training/main_sync_ppo.py``).

    python -m areal_tpu_torch.training.main_sync_ppo \\
        actor.path=/ckpts/Qwen2.5-0.5B dataset.path=data.jsonl \\
        mock_tokenizer=true dataset.train_bs_n_seqs=32 group_size=8
"""

from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig
from areal_tpu_torch.training._cli import main

if __name__ == "__main__":
    main("ppo-math", PPOMATHConfig)

"""Async-PPO entry point (reference ``training/main_async_ppo.py``).

    python -m areal_tpu_torch.training.main_async_ppo \\
        actor.path=/ckpts/Qwen2.5-0.5B dataset.path=data.jsonl \\
        mock_tokenizer=true dataset.train_bs_n_seqs=32 group_size=16 \\
        max_head_offpolicyness=4 ppo.use_decoupled_loss=true
"""

from areal_tpu_torch.experiments.async_ppo_math_exp import AsyncPPOMATHConfig
from areal_tpu_torch.training._cli import main

if __name__ == "__main__":
    main("async-ppo-math", AsyncPPOMATHConfig)

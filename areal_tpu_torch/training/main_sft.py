"""SFT entry point (reference ``training/main_sft.py``).

    python -m areal_tpu_torch.training.main_sft \\
        model.path=/ckpts/Qwen2.5-0.5B dataset.path=sft.jsonl \\
        mock_tokenizer=true exp_ctrl.save_freq_steps=100 auto_eval=true \\
        auto_eval_config.data_names=eval.jsonl
"""

from areal_tpu_torch.experiments.sft_exp import SFTConfig
from areal_tpu_torch.training._cli import main

if __name__ == "__main__":
    main("sft", SFTConfig)

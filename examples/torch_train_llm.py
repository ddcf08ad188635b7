"""End-to-end federated LM training on the PyTorch/CUDA port.

The twin of ``examples/train_llm.py``: a thin wrapper over
``repro_torch.launch.train``, with the JAX CLI's flags plus ``--device``
(the card unless given ``--device cpu``). The default preset is the
CPU-feasible ``llm-tiny``; ``--preset llm-100m`` is the ~100M-parameter
configuration (every factorized layer's forward and backward on the
``xus`` / ``avt`` / ``atb`` kernels on the card), and ``--arch qwen2-7b
--smoke`` drives a registry architecture at reduced size.

Run:  PYTHONPATH=src python examples/torch_train_llm.py --rounds 40
      PYTHONPATH=src python examples/torch_train_llm.py --preset llm-100m --rounds 2
      PYTHONPATH=src python examples/torch_train_llm.py --rounds 2 --device cpu
"""
import sys

from repro_torch.launch.train import main as train_main


def main(argv=None):
    return train_main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])

"""``python -m flexdm_tpu_torch.evaluation``: the port's eval CLI."""

from .harness import main

if __name__ == "__main__":
    main()

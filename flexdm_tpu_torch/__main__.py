"""``python -m flexdm_tpu_torch``: the port's training CLI."""

from .cli import main

if __name__ == "__main__":
    main()

"""`python -m vslnet_torch`: the port's command line (vslnet_torch/cli.py)."""
from vslnet_torch.cli import main

if __name__ == "__main__":
    main()

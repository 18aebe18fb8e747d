"""CLI of the port: tpucap's ``extract``, ``train``, ``caption`` and
``evaluate`` subcommands (``python -m tpucap_torch`` or ``tpucap-torch``)."""

from tpucap_torch.cli.main import main

__all__ = ["main"]

"""Command-line tools of the port: the dataset runner (`run_euroc`), the
vocabulary tools (`train_vocab`, `vocab_recall_curve`) and the verification
drives (`drives/`).  Each runs on the first CUDA device unless asked for
another with `--device`, and refuses to run on a card that is not there."""


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the first CUDA device; "
                         "'cpu' runs the plain versions)")


def device_of(ap, name: str):
    """The torch device `name` names ("cuda" is the first card); exits through
    `ap.error` when it names a card and none is available."""
    import torch
    dev = torch.device("cuda", 0) if name == "cuda" else torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run on the CPU")
    return dev


def device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)

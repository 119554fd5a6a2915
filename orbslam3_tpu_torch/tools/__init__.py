"""Command-line tools of the port: the dataset runner (`run_euroc`) and the
verification drives (`drives/`)."""

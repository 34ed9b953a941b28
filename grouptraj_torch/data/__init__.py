"""Data of the port (counterpart of ``grouptraj/data``): ETH/UCY windowing
(numpy or the native engine), the ragged dataset, dense batching and
``data_loader``."""

from grouptraj_torch.data.reader import (  # noqa: F401
    extract_windows, load_dir, poly_fit, read_file, windowing_backend,
)
from grouptraj_torch.data.dataset import TrajectoryDataset, Window  # noqa: F401
from grouptraj_torch.data.batching import (  # noqa: F401
    DenseBatch, DenseDataset, DenseLoader,
)
from grouptraj_torch.data.loader import data_loader  # noqa: F401

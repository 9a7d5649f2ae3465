from kvzip_tpu_torch.data.loaders import load_dataset_all
from kvzip_tpu_torch.data.wrapper import DataWrapper, get_query

__all__ = ["load_dataset_all", "DataWrapper", "get_query"]

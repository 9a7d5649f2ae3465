from kvzip_tpu_torch.utils.profiling import TimeStamp, device_mem_gb
from kvzip_tpu_torch.utils.io import save_result, set_gen_length

__all__ = ["TimeStamp", "device_mem_gb", "save_result", "set_gen_length"]

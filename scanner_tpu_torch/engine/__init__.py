from .client import Client, Table
from .executor import LocalExecutor

__all__ = ["Client", "Table", "LocalExecutor"]

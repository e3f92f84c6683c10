""".env-compatible configuration loading.

Reference: src/cli/cli_server.c:137-176 loads API_HOST/API_PORT/API_PREFIX/
API_KEY/NUM_THREADS from a `.env` file via dotenv.  We keep the same file
format and variable names so a reference deployment config works unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def load_dotenv(path: str = ".env", override: bool = True) -> dict[str, str]:
    """Minimal .env parser: KEY=VALUE lines, '#' comments, optional quotes."""
    values: dict[str, str] = {}
    if not os.path.exists(path):
        return values
    with open(path, "r", encoding="utf-8") as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip().strip('"').strip("'")
            values[key] = val
            if override or key not in os.environ:
                os.environ[key] = val
    return values


@dataclass
class ServerConfig:
    """Daemon configuration.

    Defaults mirror the reference's server_cfg {1 thread, lrt 1.0, 2 Hz poll}
    (reference: include/deciphon/server/server.h:6-16); note the scan workload
    overrides lrt_threshold to 10.0 (src/server/scan.c:221) which we keep as
    ``scan_lrt_threshold``.
    """

    num_workers: int = 1
    lrt_threshold: float = 1.0
    scan_lrt_threshold: float = 10.0
    polling_rate_hz: float = 2.0
    error_backoff_s: float = 5.0
    single_run: bool = False
    api_key: str = ""
    api_url: str = ""
    cache_dir: str = "."

    @classmethod
    def from_env(cls, dotenv_path: str = ".env") -> "ServerConfig":
        load_dotenv(dotenv_path)
        host = os.environ.get("API_HOST", "127.0.0.1")
        port = os.environ.get("API_PORT", "8000")
        prefix = os.environ.get("API_PREFIX", "")
        cfg = cls()
        cfg.api_url = f"http://{host}:{port}{prefix}"
        cfg.api_key = os.environ.get("API_KEY", "")
        cfg.num_workers = int(os.environ.get("NUM_THREADS", "1"))
        return cfg

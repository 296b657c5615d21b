"""Model asset resolution: user data dir + cached-checkpoint fetch (the
port's own copy of ``emojivoice_tpu.utils.assets``).

The reference resolves vocoder names to a per-user data directory and
downloads missing files (``MATCHA_HOME`` override).  Same convention here:

* ``EMOJIVOICE_HOME`` overrides the data dir; otherwise the platform default
  (~/.local/share/emojivoice, ~/Library/Application Support/emojivoice).
* ``resolve_model("hifigan_univ_v1")`` → cached file path, fetching into the
  cache when a URL is known and the network allows; explicit paths pass
  through untouched.
* Fetching is fully gated: zero-egress environments get a clear error
  naming the cache location to drop the file into, never a crash mid-load.

Known asset URLs are the released emoji voices and the upstream Matcha-TTS
vocoders they reuse.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Optional

# The released emoji voices (GitHub release assets) and the upstream vocoders.
ASSET_URLS = {
    "emoji-hri-paige.ckpt": "https://github.com/rosielab/emojivoice/releases/download/v1.0/emoji-hri-paige.ckpt",
    "emoji-hri-olivia.ckpt": "https://github.com/rosielab/emojivoice/releases/download/v1.0/emoji-hri-olivia.ckpt",
    "emoji-hri-zach.ckpt": "https://github.com/rosielab/emojivoice/releases/download/v1.0/emoji-hri-zach.ckpt",
    "hifigan_T2_v1": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/generator_v1",
    "hifigan_univ_v1": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/g_02500000",
}


def get_user_data_dir(appname: str = "emojivoice") -> Path:
    """Per-user asset cache (the reference's get_user_data_dir with
    EMOJIVOICE_HOME in place of MATCHA_HOME)."""
    home = os.environ.get("EMOJIVOICE_HOME")
    if home is not None:
        base = Path(home).expanduser().resolve(strict=False)
    elif sys.platform == "darwin":
        base = Path("~/Library/Application Support/").expanduser()
    else:
        base = Path.home() / ".local" / "share"
    path = base / appname
    path.mkdir(parents=True, exist_ok=True)
    return path


def fetch(url: str, dest: Path, timeout: float = 60.0) -> Path:
    """Download url → dest (atomic rename).  Raises OSError on any network
    failure — callers surface the cache-dir instructions instead."""
    import urllib.request

    tmp = dest.with_suffix(dest.suffix + ".part")
    with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    tmp.rename(dest)
    return dest


def resolve_model(name_or_path: Optional[str], kind: str = "checkpoint",
                  allow_fetch: bool = True) -> Optional[str]:
    """Resolve a model argument to a local file path.

    - None passes through (caller decides, e.g. random init).
    - An existing path (file or checkpoint directory) passes through untouched.
    - A bare name is looked up in the user data dir; when missing and a URL
      is known, a download is attempted (gated — a clear RuntimeError with
      drop-in instructions on failure, the zero-egress default here).
    """
    if name_or_path is None:
        return None
    p = Path(name_or_path)
    if p.exists():
        return str(p)
    cache = get_user_data_dir()
    cached = cache / p.name
    if cached.exists():
        return str(cached)
    url = ASSET_URLS.get(p.name)
    if url is None:
        raise FileNotFoundError(
            f"{kind} {name_or_path!r} not found: not a local path, not in the cache "
            f"({cache}), and not a known released asset ({', '.join(sorted(ASSET_URLS))})"
        )
    if not allow_fetch:
        raise RuntimeError(
            f"{kind} {name_or_path!r} is a known released asset but fetching is disabled; "
            f"download {url} into {cache}/"
        )
    try:
        print(f"[-] {kind} {p.name} not cached; downloading to {cached} ...", flush=True)
        return str(fetch(url, cached))
    except Exception as e:  # noqa: BLE001 — zero-egress environments land here
        raise RuntimeError(
            f"could not download {kind} {p.name!r} ({e}); place the file at {cached} "
            f"manually (source: {url})"
        ) from e

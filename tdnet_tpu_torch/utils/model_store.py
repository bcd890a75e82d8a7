"""Pretrained backbone store: download + SHA1-verified cache + importers
(the port's copy of ``tdnet_tpu/utils/model_store.py``).

Reference (Training/ptsemseg/models/td4_psp/utils/{model_store,files}.py):
ImageNet backbone weights come from torchvision URLs (resnet18/34) or
the SHA1-pinned encoding model zoo (resnet50s/101s/152s with deep
stems, shipped as .zip), cached under ~/.encoding/models
(model_store.py:35-83, files.py:22-85). This module mirrors that
capability: resolve from local caches first (~/.encoding/models,
$TORCH_HOME/hub/checkpoints, or an explicit path), download on miss
(``download()``; honors the reference's ``ENCODING_REPO`` env override,
which also makes it testable offline via ``file://`` repos), verify the
SHA1 prefix, and convert the torch state dict into a ``ResNet``'s state
entries. When the environment has no egress the download fails within
``URL_TIMEOUT`` seconds with a clear error and the loaders surface a miss
(a warning and ``None``) instead of crashing.

torchvision checkpoints use the same layer naming as the reference's
resnets (conv1/bn1/layerX.Y.{convZ,bnZ,downsample}) so
``resnet_from_torch`` applies with an empty prefix; fc weights are
ignored.
"""

from __future__ import annotations

import hashlib
import os
import warnings
import zipfile

# Pinned digests, tagged with their algorithm. torchvision names carry
# a sha256 prefix embedded in the torchvision filename convention; the
# "s" (deep-stem) variants carry the full SHA1 from the reference zoo
# table (td4_psp/utils/model_store.py:9-25, where the zoo's catalog
# names them plain resnet50/101/152). Each entry verifies against its
# own digest only — a prefix is never given two algorithms to match.
KNOWN_DIGESTS = {
    "resnet18": ("sha256", "5c106cde"),
    "resnet34": ("sha256", "333f7ec4"),
    "resnet50": ("sha256", "19c8e357"),
    "resnet101": ("sha256", "5d3b4d8f"),
    "resnet152": ("sha256", "b121ed2d"),
    # encoding-zoo deep-stem variants (reference model_store.py:10-12)
    "resnet50s": ("sha1", "25c4b50959ef024fcc050213a06b614899f94b3d"),
    "resnet101s": ("sha1", "2a57e44de9c853fa015b172309a1ee7e2d0e4e2a"),
    "resnet152s": ("sha1", "0d43d698c66aceaa2bc0309f55efdd7ff4b143af"),
}

# Download sources. torchvision ships flat .pth files; the encoding zoo
# ships ``{name}-{short_hash}.zip`` archives containing the .pth
# (reference model_store.py:27-28,69-78). The zoo's catalog names the
# deep-stem models plain "resnet50/101/152" — map our "s" aliases onto
# them. ENCODING_REPO overrides the zoo base URL (reference
# model_store.py:70), which is also the offline-test hook (file://).
TORCHVISION_URL = "https://download.pytorch.org/models/{name}-{sha}.pth"
ENCODING_REPO_URL = "https://hangzh.s3.amazonaws.com/"
ENCODING_URL_FORMAT = "{repo}encoding/models/{name}-{sha}.zip"
ENCODING_ZOO_ALIAS = {"resnet50s": "resnet50", "resnet101s": "resnet101",
                      "resnet152s": "resnet152"}
URL_TIMEOUT = 30   # seconds a connection may take before a download counts as failed


def _candidate_dirs(root: str | None):
    dirs = []
    if root:
        dirs.append(os.path.expanduser(root))
    dirs.append(os.path.expanduser("~/.encoding/models"))
    torch_home = os.environ.get("TORCH_HOME",
                                os.path.expanduser("~/.cache/torch"))
    dirs.append(os.path.join(torch_home, "hub", "checkpoints"))
    return dirs


def _digest(filename: str, algo: str) -> str:
    h = hashlib.new(algo)
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def check_sha1(filename: str, sha1_prefix: str, algo: str = "sha1") -> bool:
    """reference files.py:86-102: a file verifies when the given hex
    prefix matches its digest under ``algo`` (sha1 for the encoding-zoo
    convention, sha256 for torchvision/torch.hub filenames)."""
    digest = _digest(filename, algo)
    l = min(len(digest), len(sha1_prefix))
    return digest[:l] == sha1_prefix[:l]


def download(url: str, fname: str, sha: str | None = None, algo: str = "sha1") -> str:
    """Fetch ``url`` to ``fname`` (replacing it) and verify it against ``sha``
    where given (reference files.py:22-85).

    urllib-based (supports https and, for offline tests / local mirrors,
    ``file://``). Raises on network failure (after ``URL_TIMEOUT`` seconds
    without an answer) or digest mismatch.
    """
    import urllib.request

    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    tmp = fname + ".part"
    with urllib.request.urlopen(url, timeout=URL_TIMEOUT) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1048576)
            if not chunk:
                break
            f.write(chunk)
    if sha and not check_sha1(tmp, sha, algo):
        os.remove(tmp)
        raise ValueError(f"downloaded file for {url} has a different hash")
    os.replace(tmp, fname)
    return fname


def _download_on_miss(name: str, root: str | None) -> str | None:
    """Fetch ``name`` into the cache (reference model_store.py:53-83)."""
    algo_sha = KNOWN_DIGESTS.get(name)
    if algo_sha is None:
        return None
    algo, sha = algo_sha
    dest = os.path.expanduser(root or "~/.encoding/models")
    file_name = f"{name}-{sha[:8]}"
    try:
        if name in ENCODING_ZOO_ALIAS:  # zoo ships {zooname}-{hash}.zip
            zoo = ENCODING_ZOO_ALIAS[name]
            repo = os.environ.get("ENCODING_REPO", ENCODING_REPO_URL)
            if not repo.endswith("/"):
                repo += "/"
            url = ENCODING_URL_FORMAT.format(repo=repo, name=zoo,
                                             sha=sha[:8])
            zip_path = os.path.join(dest, file_name + ".zip")
            download(url, zip_path)
            member = f"{zoo}-{sha[:8]}.pth"
            target = os.path.join(dest, file_name + ".pth")
            with zipfile.ZipFile(zip_path) as zf:
                # extract ONLY the expected member — never unpack
                # arbitrary archive contents into the cache dir
                with zf.open(member) as src, open(target + ".part", "wb") as out:
                    while True:
                        chunk = src.read(1048576)
                        if not chunk:
                            break
                        out.write(chunk)
            os.remove(zip_path)
            if not check_sha1(target + ".part", sha, algo):
                os.remove(target + ".part")
                raise ValueError(f"{target}: hash mismatch after download")
            os.replace(target + ".part", target)
            return target
        url = TORCHVISION_URL.format(name=name, sha=sha[:8])
        return download(url, os.path.join(dest, file_name + ".pth"), sha, algo)
    except (OSError, zipfile.BadZipFile, KeyError, ValueError) as e:
        # no egress / bad mirror / truncated archive: clear miss, no
        # crash (URLError and timeouts are OSErrors; KeyError = missing zip member)
        warnings.warn(f"pretrained '{name}' not cached and download "
                      f"failed ({e}); proceeding without it")
        return None


def get_model_file(name: str, root: str | None = None) -> str | None:
    """Locate a cached pretrained checkpoint for ``name``; on miss,
    download it into the cache (reference model_store.py:35-83). Returns
    None when absent and unfetchable (e.g. no egress)."""
    algo_sha = KNOWN_DIGESTS.get(name)
    for d in _candidate_dirs(root):
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            stem = fn.split(".")[0]
            base = stem.split("-")[0]
            if base != name:
                continue
            path = os.path.join(d, fn)
            if algo_sha and "-" in stem:
                if not check_sha1(path, stem.split("-")[1], algo_sha[0]):
                    continue
            return path
    return _download_on_miss(name, root)


def load_imagenet_backbone(name: str, cfg, root: str | None = None):
    """Load + convert an ImageNet-pretrained backbone if cached locally.

    cfg: ``tdnet_tpu_torch.nn.resnet.ResNetConfig``. Returns a ``ResNet``'s
    state dict or None when no cached checkpoint exists (nor downloads).
    """
    path = get_model_file(name, root)
    if path is None:
        return None
    from tdnet_tpu_torch.utils.torch_import import (load_torch_state, log_unread, reader,
                                                    resnet_from_torch)
    sd = reader({k: v for k, v in load_torch_state(path).items() if not k.startswith("fc.")})
    state = resnet_from_torch(sd, cfg, prefix="")
    log_unread(sd, path)
    return state

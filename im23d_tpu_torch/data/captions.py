"""Caption tokenization: CUB text annotations -> ``captions_tokens.npz``,
a numpy copy of ``im23d_tpu/data/captions.py`` (the same tokenizer,
vocabulary order and file, byte for byte the same arrays).

The CUB caption .txt files (AttnGAN layout, ``text/<class>/<image>.txt``,
~10 captions per image) become one npz cache that
``im23d_tpu_torch.data.pseudogt.PseudoGTDataset`` reads:

* ``tokens``  (N, E, L) int32 — E captions per image, 0-padded to L words
* ``lengths`` (N, E) int32    — pre-padding caption lengths
* ``n_words`` int             — vocabulary size incl. the 0 pad id
* ``vocab``   (n_words,) str  — index -> word ('<pad>' at 0)

Build it once per dataset:
    python -m im23d_tpu_torch.data.captions --cache_dir cache/cub \
        --text_dir datasets/cub/text
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

_WORD_RE = re.compile(r"[a-z]+")

PAD = "<pad>"


def tokenize(sentence: str) -> list[str]:
    """Lowercase word tokenizer (AttnGAN keeps alphabetic tokens only)."""
    return _WORD_RE.findall(sentence.lower())


def build_vocab(captions_per_image) -> dict[str, int]:
    """word -> id, pad = 0, words ordered by first appearance."""
    vocab = {PAD: 0}
    for caps in captions_per_image:
        for cap in caps:
            for w in cap:
                if w not in vocab:
                    vocab[w] = len(vocab)
    return vocab


def encode(caption: list[str], vocab: dict[str, int], max_length: int):
    ids = [vocab[w] for w in caption if w in vocab][:max_length]
    length = len(ids)
    return ids + [0] * (max_length - length), length


def read_caption_file(path: str) -> list[list[str]]:
    with open(path, encoding="utf-8", errors="ignore") as fh:
        caps = [tokenize(line) for line in fh]
    return [c for c in caps if c]


def build_caption_cache(cache_dir: str, text_dir: str,
                        embeddings_num: int = 10, max_length: int = 18,
                        out_name: str = "captions_tokens.npz") -> str:
    """Tokenize captions for every image in poses_metadata order.

    ``text_dir`` holds ``<image_path_without_ext>.txt`` per image (the CUB
    AttnGAN layout mirrors the image tree).  Images without a caption file
    get all-pad captions (they train unconditionally for the text branch).
    """
    meta = np.load(os.path.join(cache_dir, "poses_metadata.npz"),
                   allow_pickle=True)
    paths = [str(p) for p in meta["data"].item()["path"]]

    per_image = []
    for p in paths:
        txt = os.path.join(text_dir, os.path.splitext(p)[0] + ".txt")
        caps = read_caption_file(txt) if os.path.exists(txt) else []
        caps = caps[:embeddings_num]
        n_real = len(caps)  # cycle the real captions when padding to E
        while len(caps) < embeddings_num:
            caps.append(caps[len(caps) % n_real] if n_real else [])
        per_image.append(caps)

    vocab = build_vocab(per_image)
    N, E, L = len(paths), embeddings_num, max_length
    tokens = np.zeros((N, E, L), np.int32)
    lengths = np.zeros((N, E), np.int32)
    for i, caps in enumerate(per_image):
        for e, cap in enumerate(caps):
            ids, n = encode(cap, vocab, L)
            tokens[i, e] = ids
            lengths[i, e] = n

    words = np.array(
        [w for w, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    )
    out = os.path.join(cache_dir, out_name)
    np.savez(out, tokens=tokens, lengths=lengths, n_words=len(vocab),
             vocab=words)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cache_dir", type=str, required=True,
                   help="cache dir holding poses_metadata.npz")
    p.add_argument("--text_dir", type=str, required=True,
                   help="caption .txt tree mirroring the image paths")
    p.add_argument("--embeddings_num", type=int, default=10,
                   help="captions kept per image")
    p.add_argument("--max_length", type=int, default=18,
                   help="tokens per caption (reference --text_max_length)")
    args = p.parse_args(argv)
    out = build_caption_cache(args.cache_dir, args.text_dir,
                              args.embeddings_num, args.max_length)
    cap = np.load(out)
    print(f"wrote {out}: tokens {cap['tokens'].shape}, "
          f"n_words {int(cap['n_words'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

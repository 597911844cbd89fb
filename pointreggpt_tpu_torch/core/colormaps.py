"""256-entry RGB lookup tables of matplotlib's ``gray`` and ``plasma``
colormaps, and their application to an image.

The tables are matplotlib 3.10.8's own (``colormaps[name](range(256),
bytes=True)``, alpha 255 throughout), so :func:`to_rgba` gives the pixels
``matplotlib.image.imsave(path, x, cmap=name, vmin=0, vmax=1)`` writes for
a [0, 1] image: index ``int(x * 256)``, 1.0 in the last entry, NaN fully
transparent. ``plasma`` is one of the viridis family by van der Walt and
Smith, released under CC0.
"""

from __future__ import annotations

import numpy as np

GRAY = bytes.fromhex(
    "0000000101010202020303030404040505050606060707070808080909090a0a"
    "0a0b0b0b0c0c0c0d0d0d0e0e0e0f0f0f10101011111112121213131314141415"
    "15151616161717171818181919191a1a1a1b1b1b1c1c1c1d1d1d1e1e1e1f1f1f"
    "2020202020202222222323232424242424242626262727272828282828282a2a"
    "2a2b2b2b2c2c2c2c2c2c2e2e2e2f2f2f30303030303032323233333334343434"
    "34343636363737373838383838383a3a3a3b3b3b3c3c3c3c3c3c3e3e3e3f3f3f"
    "4040404141414141414343434444444545454646464747474848484949494949"
    "494b4b4b4c4c4c4d4d4d4e4e4e4f4f4f50505051515151515153535354545455"
    "55555656565757575858585959595959595b5b5b5c5c5c5d5d5d5e5e5e5f5f5f"
    "6060606161616161616363636464646565656666666767676868686969696969"
    "696b6b6b6c6c6c6d6d6d6e6e6e6f6f6f70707071717171717173737374747475"
    "75757676767777777878787979797979797b7b7b7c7c7c7d7d7d7e7e7e7f7f7f"
    "8080808181818282828383838383838585858686868787878888888989898a8a"
    "8a8b8b8b8c8c8c8d8d8d8e8e8e8f8f8f90909091919192929293939393939395"
    "95959696969797979898989999999a9a9a9b9b9b9c9c9c9d9d9d9e9e9e9f9f9f"
    "a0a0a0a1a1a1a2a2a2a3a3a3a3a3a3a5a5a5a6a6a6a7a7a7a8a8a8a9a9a9aaaa"
    "aaabababacacacadadadaeaeaeafafafb0b0b0b1b1b1b2b2b2b3b3b3b3b3b3b5"
    "b5b5b6b6b6b7b7b7b8b8b8b9b9b9babababbbbbbbcbcbcbdbdbdbebebebfbfbf"
    "c0c0c0c1c1c1c2c2c2c3c3c3c3c3c3c5c5c5c6c6c6c7c7c7c8c8c8c9c9c9caca"
    "cacbcbcbcccccccdcdcdcecececfcfcfd0d0d0d1d1d1d2d2d2d3d3d3d3d3d3d5"
    "d5d5d6d6d6d7d7d7d8d8d8d9d9d9dadadadbdbdbdcdcdcdddddddedededfdfdf"
    "e0e0e0e1e1e1e2e2e2e3e3e3e3e3e3e5e5e5e6e6e6e7e7e7e8e8e8e9e9e9eaea"
    "eaebebebecececedededeeeeeeefefeff0f0f0f1f1f1f2f2f2f3f3f3f3f3f3f5"
    "f5f5f6f6f6f7f7f7f8f8f8f9f9f9fafafafbfbfbfcfcfcfdfdfdfefefeffffff"
)
PLASMA = bytes.fromhex(
    "0c078610078713068915068a18068b1b068c1d068d1f058e21058f2305902505"
    "912705922905932b05942d04942f04953104963304973404983604983804993a"
    "049a3b039a3d039b3f039c40039c42039d44039e45039e47029f49029f4a02a0"
    "4c02a14e02a14f02a25101a25201a35401a35601a35701a45901a45a00a55c00"
    "a55e00a55f00a66100a66200a66400a76500a76700a76800a76a00a76c00a86d"
    "00a86f00a87000a87200a87300a87500a87601a87801a87901a87b02a87c02a7"
    "7e03a77f03a78104a78204a78405a68506a68607a68807a58908a58b09a48c0a"
    "a48e0ca48f0da3900ea3920fa29310a19511a19612a09713a099149f9a159e9b"
    "179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
    "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e"
    "8cb62f8bb7308ab83289b93388ba3487bb3586bc3685bd3784be3883bf3982c0"
    "3b81c13c80c23d80c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678"
    "cb4777cc4876cd4975ce4a75cf4b74d04d73d14e72d14f71d25070d3516fd452"
    "6ed5536dd6556dd7566cd7576bd8586ad95969da5a68db5b67dc5d66dc5e66dd"
    "5f65de6064df6163df6262e06461e16560e26660e3675fe3685ee46a5de56b5c"
    "e56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455eb7654ec7754ec78"
    "53ed7952ed7b51ee7c50ef7d4fef7e4ef0804df0814df1824cf2844bf2854af3"
    "8649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
    "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba3"
    "37fba436fca635fca735fca934fcaa33fcac32fcad31fdaf31fdb030fdb22ffd"
    "b32efdb52dfdb62dfdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328"
    "fdc427fdc626fcc726fcc926fccb25fccc25fcce25fbd024fbd124fbd324fad5"
    "24fad624fad824f9d924f9db24f8dd24f8df24f7e024f7e225f6e425f6e525f5"
    "e726f5e926f4ea26f3ec26f3ee26f2f026f2f126f1f326f0f525f0f623eff821"
)

LUTS = {name: np.frombuffer(table, np.uint8).reshape(256, 3)
        for name, table in (("gray", GRAY), ("plasma", PLASMA))}


def to_rgba(x: np.ndarray, cmap: str) -> np.ndarray:
    """(h, w) values in [0, 1] -> (h, w, 4) uint8 RGBA through ``cmap``."""
    xa = np.array(x, dtype=np.float32) * np.float32(256)
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0, xa), 0, 255).astype(np.int64)
    rgba = np.empty(x.shape + (4,), np.uint8)
    rgba[..., :3] = LUTS[cmap][idx]
    rgba[..., 3] = 255
    rgba[bad] = 0
    return rgba


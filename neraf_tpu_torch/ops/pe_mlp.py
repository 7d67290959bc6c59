"""Fourier PE + ReLU MLP: the plain version and the kernel dispatch
(counterpart of neraf_tpu/ops/pallas/fused_pe_mlp.py::pe_mlp, forward and
backward).

`layers` is a list of (weight (out, in), bias (out,)) pairs, PyTorch's
layout: layer 0 consumes the (6F + 3)-wide nerf_encoding [sin | cos | x],
the hidden layers are ReLU, the last is linear. ``pe_mlp`` runs the plain
version for a CPU tensor (differentiated by autograd) and the hand-written
CUDA kernels for a CUDA tensor (csrc/pe_mlp.cu forward, csrc/pe_mlp_bwd.cu
backward, through ops/cuda/pe_mlp.py), with no fallback between them.
"""

from __future__ import annotations

import torch

from neraf_tpu_torch.ops.encodings import nerf_encoding

# hidden widths the kernel is compiled for; a layer is zero-padded up to one
KERNEL_HIDDEN_WIDTHS = (16, 32, 64, 128, 256)


def dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """A flax Dense layer in `dtype` on PyTorch's (out, in) weight: cast the
    input and the parameters, matmul, bias add."""
    return h.to(dtype) @ w.to(dtype).T + b.to(dtype)


def pe_mlp_plain(x: torch.Tensor, layers, num_frequencies: int = 6,
                 min_exp: float = 0.0, max_exp: float = 8.0,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (N, 3) -> (N, O) pre-activation, the JAX fields' layer chain off
    the TPU: nerf_encoding, then each layer in `dtype` as DenseParams
    computes it (`dense`). Returned in float32, or float64
    when `dtype` is float64 (the encoding too: its angles reach 2^8 turns,
    which float32 rounds by ~1e-4 rad)."""
    wide = torch.promote_types(x.dtype, dtype)
    h = nerf_encoding(x.to(wide), num_frequencies, min_exp, max_exp)
    for i, (w, b) in enumerate(layers):
        h = dense(h, w, b, dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.to(torch.promote_types(dtype, torch.float32))


def pe_mlp(x: torch.Tensor, layers, num_frequencies: int = 6,
           min_exp: float = 0.0, max_exp: float = 8.0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused nerf_encoding + ReLU MLP: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (or it raises)."""
    from neraf_tpu_torch.ops.cuda.pe_mlp import pe_mlp_cuda

    return pe_mlp_cuda(x, layers, num_frequencies, min_exp, max_exp, dtype)


def pe_mlp_vjp_plain(x: torch.Tensor, layers, g: torch.Tensor,
                     num_frequencies: int = 6, min_exp: float = 0.0,
                     max_exp: float = 8.0, dtype: torch.dtype = torch.float32):
    """Autograd of pe_mlp_plain for the output cotangent g (N, O): dx (N, 3)
    and [(dW, db)] in `layers`' layout and dtypes."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        params = [t.detach().requires_grad_() for wb in layers for t in wb]
        out = pe_mlp_plain(xs, list(zip(params[::2], params[1::2])),
                           num_frequencies, min_exp, max_exp, dtype)
        grads = torch.autograd.grad(out, [xs, *params], g.to(out.dtype))
    return grads[0], list(zip(grads[1::2], grads[2::2]))


def split_first_layer(w0: torch.Tensor, num_frequencies: int):
    """Layer 0's (H, 6F + 3) weight -> its sin, cos and x blocks (H, 3F),
    (H, 3F), (H, 3): the column blocks that meet the encoding's parts."""
    df = 3 * num_frequencies
    if w0.shape[-1] != 2 * df + 3:
        raise ValueError(f"layer 0 takes {w0.shape[-1]} inputs, the encoding "
                         f"of F={num_frequencies} has {2 * df + 3}")
    return w0[:, :df], w0[:, df:2 * df], w0[:, 2 * df:]


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_layers(layers, num_frequencies: int, dtype: torch.dtype):
    """The kernel's form of `layers` (the counterpart of the Pallas
    kernel's _prep): every weight zero-padded, the hidden width to one of
    KERNEL_HIDDEN_WIDTHS (hp), layer 0's input to a multiple of 16 (k0p),
    the output to a multiple of 8 (op); layer 0's columns interleaved as
    [sin_0, cos_0, sin_1, cos_1, ..., x0, x1, x2, 0...] so that a pair of
    adjacent columns is one angle's sincos. Returns the weights flattened
    into one `dtype` buffer, the biases into one float32 buffer, and the
    dims (k0p, hp, op, n_hidden, out_dim)."""
    F = num_frequencies

    def interleaved(w0, hp, k0p):
        w_sin, w_cos, w_x = split_first_layer(w0, F)
        first = w0.new_zeros((hp, k0p))
        first[:w0.shape[0], 0:6 * F:2] = w_sin
        first[:w0.shape[0], 1:6 * F:2] = w_cos
        first[:w0.shape[0], 6 * F:6 * F + 3] = w_x
        return first

    return pack_chain(layers, _ceil(6 * F + 3, 16), interleaved, dtype)


def pack_chain(layers, k0p: int, first_layer, dtype: torch.dtype):
    """pack_layers' padding for a ReLU chain whose layer 0 takes k0p
    (padded) inputs: first_layer(w0, hp, k0p) gives layer 0's (hp, k0p)
    weight in the kernel's column order; the other layers and the biases
    are zero-padded as pack_layers says."""
    if len(layers) < 2:
        raise ValueError("the chain needs at least one hidden layer")
    w0, b0 = layers[0]
    hidden = w0.shape[0]
    for w, _ in layers[1:-1]:
        if tuple(w.shape) != (hidden, hidden):
            raise ValueError(f"hidden layer {tuple(w.shape)} is not "
                             f"({hidden}, {hidden})")
    wo, bo = layers[-1]
    if wo.shape[1] != hidden:
        raise ValueError(f"output layer takes {wo.shape[1]}, not {hidden}")
    fits = [h for h in KERNEL_HIDDEN_WIDTHS if h >= hidden]
    if not fits:
        raise ValueError(f"hidden width {hidden} > {KERNEL_HIDDEN_WIDTHS[-1]}")
    hp, op = fits[0], _ceil(wo.shape[0], 8)

    weights = [first_layer(w0, hp, k0p)]
    weights += [padded(w, (hp, hp)) for w, _ in layers[1:-1]]
    weights.append(padded(wo, (op, hp)))
    biases = ([padded(b0, (hp,))] + [padded(b, (hp,)) for _, b in layers[1:-1]]
              + [padded(bo, (op,))])
    w_flat = torch.cat([w.reshape(-1) for w in weights]).to(dtype).contiguous()
    b_flat = torch.cat(biases).to(torch.float32).contiguous()
    dims = dict(k0p=k0p, hp=hp, op=op, n_hidden=len(layers) - 1,
                out_dim=wo.shape[0])
    return w_flat, b_flat, dims


def padded(t: torch.Tensor, shape) -> torch.Tensor:
    """t zero-padded at the end of each dimension to `shape`."""
    out = t.new_zeros(shape)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def chunk_rows(hp: int) -> int:
    """Rows of a weight chunk in tile_layers' layout (the bf16 kernels'
    unit of staging): a layer of HP > 128 rows is cut in 128-row chunks."""
    return min(hp, 128)


def tile_layers(w_flat: torch.Tensor, dims: dict) -> torch.Tensor:
    """pack_layers' weights -> the layout the bf16 kernels read with wgmma
    (csrc/pe_mlp_common.cuh): each layer's rows cut into chunks of
    chunk_rows(hp) (the output layer, its rows zero-padded to a multiple of
    16, one chunk), and a chunk of R x C stored as 8 x 8 core matrices
    (row-major inside), core matrix (i, j) (rows 8i.., columns 8j..) at
    element 64 (j R / 8 + i). Layers and chunks stay in order."""
    k0p, hp, op, n_hidden = dims["k0p"], dims["hp"], dims["op"], dims["n_hidden"]
    out, off = [], 0
    for i in range(n_hidden + 1):
        last = i == n_hidden
        rows, cols = (op, hp) if last else (hp, k0p if i == 0 else hp)
        w = w_flat[off:off + rows * cols].reshape(rows, cols)
        off += rows * cols
        if last:
            w = padded(w, (_ceil(op, 16), cols))
        r = w.shape[0] if last else chunk_rows(hp)
        out.append(w.reshape(-1, r // 8, 8, cols // 8, 8)
                   .permute(0, 3, 1, 2, 4).reshape(-1))
    return torch.cat(out).contiguous()


def unpack_layers(w_flat: torch.Tensor, b_flat: torch.Tensor, dims: dict,
                  num_frequencies: int, hidden: int):
    """The inverse of pack_layers: packed weights and biases (or their
    gradients, in the same layout) -> [(W (out, in), b (out,))] in PyTorch's
    layout, the padding dropped and layer 0's columns back in
    [sin | cos | x] order."""
    F = num_frequencies
    k0p, hp, op = dims["k0p"], dims["hp"], dims["op"]
    n_hidden, out_dim = dims["n_hidden"], dims["out_dim"]
    first = w_flat[:hp * k0p].reshape(hp, k0p)[:hidden]
    w0 = torch.cat([first[:, 0:6 * F:2], first[:, 1:6 * F:2],
                    first[:, 6 * F:6 * F + 3]], 1)
    out = [(w0, b_flat[:hidden])]
    off = hp * k0p
    for i in range(1, n_hidden):
        w = w_flat[off:off + hp * hp].reshape(hp, hp)[:hidden, :hidden]
        out.append((w, b_flat[i * hp:i * hp + hidden]))
        off += hp * hp
    wo = w_flat[off:off + op * hp].reshape(op, hp)[:out_dim, :hidden]
    out.append((wo, b_flat[n_hidden * hp:n_hidden * hp + out_dim]))
    return out

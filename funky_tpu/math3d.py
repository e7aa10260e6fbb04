"""glam-equivalent 3D math with the reference renderer's exact conventions.

The reference (funky-renderer) uses the Rust `glam` crate everywhere; pixel
parity requires matching its conventions exactly:

- Matrices act on column vectors: ``p' = M @ p``.
- ``look_at_rh(eye, center, up)`` — right-handed view matrix
  (reference: gltf_renderer.rs:1815, cube usage renderer-side).
- ``perspective_rh(fovy, aspect, near, far)`` — right-handed projection with
  a **0..1 clip-space depth range** (Vulkan), then the reference flips Y:
  ``proj.y_axis.y *= -1`` (gltf_renderer.rs:1819-1820). Use
  :func:`perspective_vk` for the flipped version.
- ``orthographic_rh`` — 0..1 depth range (cascade fit,
  gltf_renderer.rs:1941-1944).
- Quaternions: ``from_rotation_y`` (duck faces camera,
  gltf_renderer.rs:1810-1811), ``from_euler(YXZ, ...)`` (rotation_system,
  main.rs:190-196).

Everything here works on numpy or jax.numpy arrays (pass the namespace you
want via arrays; functions use the ops of their inputs through jnp, which
also accepts numpy). Host-side scene setup uses numpy; in-jit uniform math
uses jax.
"""

from __future__ import annotations

import jax.numpy as jnp


def normalize(v, eps: float = 0.0):
    """Normalize the last axis. With eps=0 matches glam `normalize`
    (inf/nan on zero vectors); pass eps>0 for `normalize_or_zero`-ish
    safety."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    if eps:
        return jnp.where(n > eps, v / jnp.maximum(n, eps), jnp.zeros_like(v))
    return v / n


def cross(a, b):
    return jnp.cross(a, b)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def look_at_rh(eye, center, up):
    """Right-handed look-at view matrix (glam `Mat4::look_at_rh`).

    Maps world space to view space where the camera looks down -Z.
    """
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = normalize(center - eye)          # forward
    s = normalize(jnp.cross(f, up))      # right
    u = jnp.cross(s, f)                  # corrected up
    m = jnp.stack([
        jnp.concatenate([s, -jnp.dot(s, eye)[None]]),
        jnp.concatenate([u, -jnp.dot(u, eye)[None]]),
        jnp.concatenate([-f, jnp.dot(f, eye)[None]]),
        jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
    ])
    return m


def perspective_rh(fovy, aspect, near, far):
    """glam `Mat4::perspective_rh` — RH, depth mapped to [0, 1] (Vulkan).

    z=-near maps to ndc 0, z=-far maps to ndc 1.
    """
    fovy = jnp.asarray(fovy, jnp.float32)
    f = 1.0 / jnp.tan(fovy * 0.5)
    zero = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)
    near = jnp.asarray(near, jnp.float32)
    far = jnp.asarray(far, jnp.float32)
    aspect = jnp.asarray(aspect, jnp.float32)
    r = far / (near - far)
    m = jnp.stack([
        jnp.stack([f / aspect, zero, zero, zero]),
        jnp.stack([zero, f, zero, zero]),
        jnp.stack([zero, zero, r, r * near]),
        jnp.stack([zero, zero, -one, zero]),
    ])
    return m


def perspective_vk(fovy, aspect, near, far):
    """Reference projection: perspective_rh with the Vulkan Y flip applied
    (`proj.y_axis.y *= -1`, gltf_renderer.rs:1819-1820). With this flip,
    NDC +Y points *down*, matching Vulkan framebuffer row order."""
    m = perspective_rh(fovy, aspect, near, far)
    return m.at[1, 1].mul(-1.0)


def orthographic_rh(left, right, bottom, top, near, far):
    """glam `Mat4::orthographic_rh` — RH, depth in [0, 1].

    Used for the cascade light projections (gltf_renderer.rs:1941-1944).
    """
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    bottom = jnp.asarray(bottom, jnp.float32)
    top = jnp.asarray(top, jnp.float32)
    near = jnp.asarray(near, jnp.float32)
    far = jnp.asarray(far, jnp.float32)
    rw = 1.0 / (right - left)
    rh = 1.0 / (top - bottom)
    rd = 1.0 / (near - far)
    zero = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)
    m = jnp.stack([
        jnp.stack([2.0 * rw, zero, zero, -(right + left) * rw]),
        jnp.stack([zero, 2.0 * rh, zero, -(top + bottom) * rh]),
        jnp.stack([zero, zero, rd, near * rd]),
        jnp.stack([zero, zero, zero, one]),
    ])
    return m


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) — glam layout
# ---------------------------------------------------------------------------

def quat_identity():
    return jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)


def quat_from_rotation_x(angle):
    h = jnp.asarray(angle, jnp.float32) * 0.5
    return jnp.stack([jnp.sin(h), jnp.zeros_like(h), jnp.zeros_like(h), jnp.cos(h)])


def quat_from_rotation_y(angle):
    h = jnp.asarray(angle, jnp.float32) * 0.5
    return jnp.stack([jnp.zeros_like(h), jnp.sin(h), jnp.zeros_like(h), jnp.cos(h)])


def quat_from_rotation_z(angle):
    h = jnp.asarray(angle, jnp.float32) * 0.5
    return jnp.stack([jnp.zeros_like(h), jnp.zeros_like(h), jnp.sin(h), jnp.cos(h)])


def quat_mul(a, b):
    """Hamilton product a*b (glam `Quat::mul`): rotation b applied first."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def quat_from_euler_yxz(y, x, z):
    """glam `Quat::from_euler(EulerRot::YXZ, y, x, z)` — used by the
    reference `rotation_system` (main.rs:190-196): intrinsic Y, then X,
    then Z."""
    qy = quat_from_rotation_y(y)
    qx = quat_from_rotation_x(x)
    qz = quat_from_rotation_z(z)
    return quat_mul(quat_mul(qy, qx), qz)


def mat3_from_quat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return jnp.stack([
        jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
        jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
        jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
    ], axis=-2)


def mat4_from_scale_rotation_translation(scale, rotation, translation):
    """glam `Mat4::from_scale_rotation_translation` (duck model matrix,
    gltf_renderer.rs:1811)."""
    scale = jnp.asarray(scale, jnp.float32)
    if scale.ndim == 0:
        scale = jnp.broadcast_to(scale, (3,))
    r = mat3_from_quat(rotation) * scale[None, :]
    t = jnp.asarray(translation, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(r)
    m = m.at[:3, 3].set(t)
    return m


def mat4_from_translation(t):
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(jnp.asarray(t, jnp.float32))


def mat4_from_rotation_y(angle):
    return mat4_from_scale_rotation_translation(
        jnp.ones(3, jnp.float32), quat_from_rotation_y(angle),
        jnp.zeros(3, jnp.float32))


def mat4_from_rotation_x(angle):
    return mat4_from_scale_rotation_translation(
        jnp.ones(3, jnp.float32), quat_from_rotation_x(angle),
        jnp.zeros(3, jnp.float32))


def mat4_from_scale(s):
    s = jnp.asarray(s, jnp.float32)
    if s.ndim == 0:
        s = jnp.broadcast_to(s, (3,))
    return jnp.diag(jnp.concatenate([s, jnp.ones(1, jnp.float32)]))


def transform_point(m, p):
    """Apply a 4x4 to a 3D point (w=1). Supports batched points (..., 3)."""
    p = jnp.asarray(p, jnp.float32)
    return p @ m[:3, :3].T + m[:3, 3]


def transform_homogeneous(m, p):
    """Apply a 4x4 to (..., 3) points, returning (..., 4) clip coords."""
    p = jnp.asarray(p, jnp.float32)
    ones = jnp.ones(p.shape[:-1] + (1,), p.dtype)
    return jnp.concatenate([p, ones], axis=-1) @ m.T


def transform_vector(m, v):
    """Rotate a direction by the upper-left 3x3 (normals with uniform scale,
    gltf.vert:42-43)."""
    v = jnp.asarray(v, jnp.float32)
    return v @ m[:3, :3].T


def rigid_inverse(view):
    """Exact inverse of a rigid transform (rotation+translation), e.g. a
    look_at view matrix: inv = [R^T | -R^T t]."""
    r = view[:3, :3]
    t = view[:3, 3]
    inv = jnp.eye(4, dtype=jnp.float32)
    inv = inv.at[:3, :3].set(r.T)
    inv = inv.at[:3, 3].set(-(r.T @ t))
    return inv


def perspective_inverse(proj):
    """Closed-form inverse of a (possibly Y-flipped) perspective_rh matrix
    [[a,0,0,0],[0,b,0,0],[0,0,c,d],[0,0,-1,0]].

    Inverting the *composite* view-proj numerically (as the reference does,
    gltf_renderer.rs:1842) catastrophically cancels the far-plane corners'
    w to exactly 0 in f32. Even the per-entry form w' = z/d + c/d cancels
    where division is computed through a reciprocal (1/d and c/d round so
    the far plane's 1/d + c/d hits exactly 0). Recovering near/far and writing the
    w row as w'(z) = 1/near + z*(1/far - 1/near) is cancellation-free:
    w'(1) = 1/far exactly.
    """
    a = proj[0, 0]
    b = proj[1, 1]
    c = proj[2, 2]
    d = proj[2, 3]
    near = d / c                 # d = c*near (see perspective_rh)
    far = d / (c + 1.0)          # c = far/(near-far) => c+1 = near/(near-far)
    inv_near = 1.0 / near
    inv_far = 1.0 / far
    zero = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)
    return jnp.stack([
        jnp.stack([1.0 / a, zero, zero, zero]),
        jnp.stack([zero, 1.0 / b, zero, zero]),
        jnp.stack([zero, zero, zero, -one]),
        jnp.stack([zero, zero, inv_far - inv_near, inv_near]),
    ])


def view_proj_inverse(view, proj):
    """Numerically robust inverse of proj @ view for frustum-corner
    reconstruction."""
    return rigid_inverse(view) @ perspective_inverse(proj)


def mat4_inverse(m):
    """Analytic 4x4 inverse via cofactor expansion (glam `Mat4::inverse`
    uses the same adjugate construction). Needed instead of
    jnp.linalg.inv: LU in f32 collapses the tiny w of inverse-projected
    far-plane corners to exactly 0 (inf corners); the adjugate keeps the
    reference's numerical behavior (used by the cascade fit,
    gltf_renderer.rs:1842)."""
    m = jnp.asarray(m, jnp.float32)
    a = m[0, 0]; b = m[0, 1]; c = m[0, 2]; d = m[0, 3]
    e = m[1, 0]; f = m[1, 1]; g = m[1, 2]; h = m[1, 3]
    i = m[2, 0]; j = m[2, 1]; k = m[2, 2]; l = m[2, 3]
    mm = m[3, 0]; n = m[3, 1]; o = m[3, 2]; p = m[3, 3]

    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm
    gp_ho = g * p - h * o
    fp_hn = f * p - h * n
    fo_gn = f * o - g * n
    ep_hm = e * p - h * mm
    eo_gm = e * o - g * mm
    en_fm = e * n - f * mm
    gl_hk = g * l - h * k
    fl_hj = f * l - h * j
    fk_gj = f * k - g * j
    el_hi = e * l - h * i
    ek_gi = e * k - g * i
    ej_fi = e * j - f * i

    c00 = f * kp_lo - g * jp_ln + h * jo_kn
    c01 = -(e * kp_lo - g * ip_lm + h * io_km)
    c02 = e * jp_ln - f * ip_lm + h * in_jm
    c03 = -(e * jo_kn - f * io_km + g * in_jm)

    det = a * c00 + b * c01 + c * c02 + d * c03
    inv_det = 1.0 / det

    c10 = -(b * kp_lo - c * jp_ln + d * jo_kn)
    c11 = a * kp_lo - c * ip_lm + d * io_km
    c12 = -(a * jp_ln - b * ip_lm + d * in_jm)
    c13 = a * jo_kn - b * io_km + c * in_jm

    c20 = b * gp_ho - c * fp_hn + d * fo_gn
    c21 = -(a * gp_ho - c * ep_hm + d * eo_gm)
    c22 = a * fp_hn - b * ep_hm + d * en_fm
    c23 = -(a * fo_gn - b * eo_gm + c * en_fm)

    c30 = -(b * gl_hk - c * fl_hj + d * fk_gj)
    c31 = a * gl_hk - c * el_hi + d * ek_gi
    c32 = -(a * fl_hj - b * el_hi + d * ej_fi)
    c33 = a * fk_gj - b * ek_gi + c * ej_fi

    adj = jnp.stack([
        jnp.stack([c00, c10, c20, c30]),
        jnp.stack([c01, c11, c21, c31]),
        jnp.stack([c02, c12, c22, c32]),
        jnp.stack([c03, c13, c23, c33]),
    ])
    return adj * inv_det


def camera_front(yaw, pitch):
    """Camera forward vector from yaw/pitch — the glTF renderer's convention
    (gltf_renderer.rs:1799-1803): x=cos(yaw)cos(pitch), y=sin(pitch),
    z=sin(yaw)cos(pitch)."""
    yaw = jnp.asarray(yaw, jnp.float32)
    pitch = jnp.asarray(pitch, jnp.float32)
    f = jnp.stack([
        jnp.cos(yaw) * jnp.cos(pitch),
        jnp.sin(pitch),
        jnp.sin(yaw) * jnp.cos(pitch),
    ])
    return normalize(f)

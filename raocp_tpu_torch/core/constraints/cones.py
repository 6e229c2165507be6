"""Convex cones with projections (host-side, spec-level API).

Parity: reference ``raocp/core/constraints/cones.py:21,49,77,104,144``.
These classes operate on single numpy vectors and exist for problem
specification and API compatibility; the solver's hot path uses the batched
tensor projections in :mod:`raocp_tpu_torch.ops.cones`, over all tree nodes.
"""

import numpy as np

__all__ = ["Real", "Zero", "NonnegativeOrthant", "SecondOrderCone",
           "Cartesian"]


def _check_dimension(cone_type, cone_dimension, vector):
    vector_dimension = vector.size
    if cone_dimension is None:
        cone_dimension = vector_dimension
    if cone_dimension != vector_dimension:
        raise ValueError(
            f"{cone_type}: expected a vector of dimension "
            f"{cone_dimension}, received one of dimension "
            f"{vector_dimension}")
    return vector_dimension


class Real:
    """The whole space R^n (projection = identity; dual cone = {0})."""

    def __init__(self, dimension=None):
        self.__dimension = dimension

    def project(self, vector):
        self.__dimension = _check_dimension(type(self), self.__dimension,
                                            vector)
        return np.array(vector, copy=True)

    def project_onto_dual(self, vector):
        self.__dimension = _check_dimension(type(self), self.__dimension,
                                            vector)
        return np.zeros_like(vector)

    @property
    def dimension(self):
        return self.__dimension


class Zero:
    """The zero cone {0} (projection = 0; dual cone = R^n)."""

    def __init__(self, dimension=None):
        self.__dimension = dimension

    def project(self, vector):
        self.__dimension = _check_dimension(type(self), self.__dimension,
                                            vector)
        return np.zeros_like(vector)

    def project_onto_dual(self, vector):
        self.__dimension = _check_dimension(type(self), self.__dimension,
                                            vector)
        return np.array(vector, copy=True)

    @property
    def dimension(self):
        return self.__dimension


class NonnegativeOrthant:
    """R^n_+ (self-dual; projection = elementwise max(0, .))."""

    def __init__(self, dimension=None):
        self.__dimension = dimension

    def project(self, vector):
        self.__dimension = _check_dimension(type(self), self.__dimension,
                                            vector)
        return np.maximum(vector, 0.0)

    def project_onto_dual(self, vector):
        return self.project(vector)

    @property
    def dimension(self):
        return self.__dimension


class SecondOrderCone:
    """The second-order (Lorentz) cone {(x, t) : ||x||_2 <= t} (self-dual).

    The projection uses the standard three-case formula
    (parity: reference ``cones.py:113-135``).
    """

    def __init__(self, dimension=None):
        self.__dimension = dimension

    def project(self, vector):
        self.__dimension = _check_dimension(type(self), self.__dimension,
                                            vector)
        if self.__dimension < 3:
            raise Exception(
                "second-order-cone projection needs at least 3 entries "
                f"(members + radial); got {self.__dimension}")
        flat = np.asarray(vector, dtype=np.float64).reshape(-1)
        x, t = flat[:-1], flat[-1]
        nx = np.linalg.norm(x)
        if nx <= t:
            return np.array(vector, copy=True)
        if nx <= -t:
            return np.zeros_like(vector)
        t_proj = (nx + t) / 2.0
        out = np.concatenate((t_proj * (x / nx), [t_proj]))
        return out.reshape(np.shape(vector))

    def project_onto_dual(self, vector):
        return self.project(vector)

    @property
    def dimension(self):
        return self.__dimension


class Cartesian:
    """Cartesian product of cones (cone x cone x ...).

    Projects a list of vectors component-wise; a single stacked vector is
    auto-split by the component cone dimensions (parity: ``cones.py:164-206``).
    """

    def __init__(self, cones):
        self.__cones = list(cones)
        self.__num_cones = len(self.__cones)
        self.__dimension = 0
        for c in self.__cones:
            if c.dimension is None:
                self.__dimension = None
                break
            self.__dimension += c.dimension
        self.__dimensions = [None] * self.__num_cones

    def _split(self, list_of_vectors):
        if len(list_of_vectors) == 1:
            parts = []
            j = 0
            for c in self.__cones:
                parts.append(list_of_vectors[0][j: j + c.dimension])
                j += c.dimension
            return parts
        return list_of_vectors

    def _apply(self, list_of_vectors, dual: bool):
        parts = self._split(list_of_vectors)
        projection = []
        for i, c in enumerate(self.__cones):
            self.__dimensions[i] = _check_dimension(type(c), c.dimension,
                                                    parts[i])
            projection.append(c.project_onto_dual(parts[i]) if dual
                              else c.project(parts[i]))
        self.__dimension = sum(self.__dimensions)
        if len(list_of_vectors) == 1:
            return np.vstack(projection)
        return projection

    def project(self, list_of_vectors):
        return self._apply(list_of_vectors, dual=False)

    def project_onto_dual(self, list_of_vectors):
        return self._apply(list_of_vectors, dual=True)

    @property
    def cones(self):
        """The component cones, in order (read-only view)."""
        return tuple(self.__cones)

    @property
    def types(self):
        product = type(self.__cones[0]).__name__
        for c in self.__cones[1:]:
            product = product + " x " + type(c).__name__
        return product

    @property
    def dimension(self):
        return self.__dimension

    @property
    def dimensions(self):
        return self.__dimensions

    @property
    def num_cones(self):
        return self.__num_cones

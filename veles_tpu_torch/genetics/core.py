"""GA core: chromosomes, crossover, mutation, selection; the port of
``veles_tpu/genetics/core.py``, drawing from the same host stream
(``prng.get(prng_key)``: numpy's PCG64), so a population evolves value
for value as the JAX package's does from the same seed.

Reference ``genetics/core.py`` implements binary+gray-code and numeric
chromosomes with uniform/one-point/two-point/arithmetic/geometric crossover,
several mutations and roulette selection. Both tiers exist here:

- **numeric** (default): gene values crossed/mutated directly;
- **gray** (``representation="gray"``): each gene quantized to
  ``accuracy`` steps and encoded as a fixed-width Gray-code bit field
  (reference ``core.py:70-120``: recursive code tables + binary-point
  mutation; here the codec is the arithmetic identity ``n ^ (n >> 1)`` —
  same codes, no tables). Crossover cuts the concatenated bit string;
  ``binary_point`` mutation flips individual bits. Gray coding keeps
  single-bit flips adjacent in value space, the property the reference's
  binary tier existed for.
"""

import math

from veles_tpu_torch.core import prng


def gray_encode(n):
    """Integer -> Gray code (reference ``gray()`` tables, core.py:70)."""
    return n ^ (n >> 1)


def gray_decode(g):
    n = 0
    while g:
        n ^= g
        g >>= 1
    return n


class GrayCodec:
    """Fixed-width Gray-code codec for one gene list (reference
    ``bin_to_num``/``num_to_bin``, core.py:86-120)."""

    def __init__(self, genes, accuracy=1000):
        self.genes = genes
        self.accuracy = accuracy
        self.widths = []
        for _, gene in genes:
            steps = max(1, int(round(
                (gene.max_value - gene.min_value) * accuracy)))
            self.widths.append(max(1, math.ceil(math.log2(steps + 1))))

    @property
    def total_bits(self):
        return sum(self.widths)

    def encode(self, values):
        bits = []
        for (_, gene), width, value in zip(self.genes, self.widths,
                                           values):
            step = int(round((value - gene.min_value) * self.accuracy))
            step = min(max(step, 0), (1 << width) - 1)
            code = gray_encode(step)
            bits.extend((code >> (width - 1 - b)) & 1
                        for b in range(width))
        return bits

    def decode(self, bits):
        values, pos = [], 0
        for (_, gene), width in zip(self.genes, self.widths):
            code = 0
            for b in bits[pos:pos + width]:
                code = (code << 1) | b
            pos += width
            value = gene.min_value + gray_decode(code) / self.accuracy
            values.append(gene.clip(value))
        return values


class Chromosome:
    """One candidate: a vector of gene values (+ fitness once evaluated)."""

    def __init__(self, genes, values):
        self.genes = genes  # [(path, Range), ...]
        self.values = list(values)
        self.fitness = None

    def config_overrides(self):
        """root.path=value strings for the evaluation subprocess."""
        return ["%s=%r" % (path, value)
                for (path, _), value in zip(self.genes, self.values)]

    def __repr__(self):
        return "<Chromosome %s fitness=%s>" % (self.values, self.fitness)


class Population:
    """Evolving population (reference ``genetics/core.py``)."""

    def __init__(self, genes, size=20, crossover="uniform",
                 mutation="gaussian", mutation_rate=0.15, elite=2,
                 representation="numeric", accuracy=1000,
                 prng_key="genetics"):
        self.genes = genes
        self.size = size
        self.crossover_type = crossover
        self.mutation_type = mutation
        self.mutation_rate = mutation_rate
        self.elite = elite
        if representation not in ("numeric", "gray"):
            raise ValueError("representation must be 'numeric' or 'gray'")
        self.representation = representation
        self.codec = (GrayCodec(genes, accuracy)
                      if representation == "gray" else None)
        if representation == "gray" and mutation == "gaussian":
            self.mutation_type = "binary_point"
        self.rng = prng.get(prng_key)
        self.generation = 0
        self.members = [self._random_member() for _ in range(size)]
        # seed one member with the declared defaults
        if self.members:
            self.members[0] = Chromosome(
                genes, [rng.default for _, rng in genes])

    def _random_member(self):
        values = []
        for _, gene in self.genes:
            span = gene.max_value - gene.min_value
            values.append(gene.clip(gene.min_value
                                    + self.rng.random_sample() * span))
        return Chromosome(self.genes, values)

    # -- selection ------------------------------------------------------------
    def roulette_pick(self):
        """Fitness-proportionate selection (reference roulette)."""
        fits = [max(m.fitness, 0.0) + 1e-9 for m in self.members]
        total = sum(fits)
        spin = self.rng.random_sample() * total
        acc = 0.0
        for member, fit in zip(self.members, fits):
            acc += fit
            if acc >= spin:
                return member
        return self.members[-1]

    # -- gray-tier operators --------------------------------------------------
    def _cross_bits(self, a, b):
        """Crossover over the concatenated Gray bit strings (reference
        ``cross_pointed``/``cross_uniform`` binary branches)."""
        abits, bbits = self.codec.encode(a.values), \
            self.codec.encode(b.values)
        n = len(abits)
        kind = self.crossover_type
        if kind == "uniform":
            bits = [abits[i] if self.rng.random_sample() < 0.5
                    else bbits[i] for i in range(n)]
        elif kind == "one_point":
            point = int(self.rng.randint(1, max(n, 2)))
            bits = abits[:point] + bbits[point:]
        else:  # two_point (cross() routes only the three bit kinds here)
            p1 = int(self.rng.randint(0, n))
            p2 = int(self.rng.randint(p1, n)) + 1
            bits = abits[:p1] + bbits[p1:p2] + abits[p2:]
        return Chromosome(self.genes, self.codec.decode(bits))

    def _mutate_bits(self, member):
        """binary_point mutation: flip bits with mutation_rate probability
        (reference ``mutation_binary_point``, core.py:260)."""
        bits = self.codec.encode(member.values)
        for i in range(len(bits)):
            if self.rng.random_sample() < self.mutation_rate:
                bits[i] ^= 1
        member.values = self.codec.decode(bits)
        return member

    # -- crossover -------------------------------------------------------------
    def cross(self, a, b):
        if self.codec is not None and self.crossover_type in (
                "uniform", "one_point", "two_point"):
            return self._cross_bits(a, b)
        n = len(a.values)
        kind = self.crossover_type
        if kind == "uniform":
            values = [a.values[i] if self.rng.random_sample() < 0.5
                      else b.values[i] for i in range(n)]
        elif kind == "one_point":
            point = int(self.rng.randint(1, max(n, 2)))
            values = a.values[:point] + b.values[point:]
        elif kind == "two_point":
            p1 = int(self.rng.randint(0, n))
            p2 = int(self.rng.randint(p1, n)) + 1
            values = a.values[:p1] + b.values[p1:p2] + a.values[p2:]
        elif kind == "arithmetic":
            w = self.rng.random_sample()
            values = [w * x + (1 - w) * y
                      for x, y in zip(a.values, b.values)]
        elif kind == "geometric":
            values = [(abs(x) * abs(y)) ** 0.5 if x * y >= 0
                      else (x + y) / 2
                      for x, y in zip(a.values, b.values)]
        else:
            raise ValueError("unknown crossover %r" % kind)
        values = [gene.clip(v)
                  for (_, gene), v in zip(self.genes, values)]
        return Chromosome(self.genes, values)

    # -- mutation --------------------------------------------------------------
    def mutate(self, member):
        if self.mutation_type == "binary_point":
            if self.codec is None:
                raise ValueError("binary_point mutation needs "
                                 "representation='gray'")
            return self._mutate_bits(member)
        for i, (_, gene) in enumerate(self.genes):
            if self.rng.random_sample() >= self.mutation_rate:
                continue
            span = gene.max_value - gene.min_value
            kind = self.mutation_type
            if kind == "gaussian":
                value = member.values[i] + self.rng.normal(0, span * 0.1)
            elif kind == "uniform":
                value = gene.min_value + self.rng.random_sample() * span
            elif kind == "altering":  # swap with another random gene slot
                j = int(self.rng.randint(0, len(self.genes)))
                member.values[i], member.values[j] = (
                    member.values[j], member.values[i])
                value = member.values[i]
            else:
                raise ValueError("unknown mutation %r" % kind)
            member.values[i] = gene.clip(value)
        return member

    # -- generation step -------------------------------------------------------
    def evolve(self):
        """Build the next generation from the evaluated current one."""
        ranked = sorted(self.members,
                        key=lambda m: m.fitness, reverse=True)
        survivors = ranked[:self.elite]
        children = [Chromosome(self.genes, list(m.values))
                    for m in survivors]
        while len(children) < self.size:
            child = self.cross(self.roulette_pick(), self.roulette_pick())
            children.append(self.mutate(child))
        self.members = children
        self.generation += 1

    @property
    def best(self):
        evaluated = [m for m in self.members if m.fitness is not None]
        return max(evaluated, key=lambda m: m.fitness) if evaluated \
            else None

"""Gaussian phenotypes with the identity link: y = eta + N(0, noise_sd^2)."""

LINKS = ("IdentityLink",)


def draw(eta, rng, phenotype):
    return eta + float(phenotype["noise_sd"]) * rng.standard_normal(len(eta))

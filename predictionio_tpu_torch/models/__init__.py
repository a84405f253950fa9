"""Engine templates of the port (counterpart of ``predictionio_tpu/models``).

``ENGINE_FACTORIES`` maps the template shortnames engine.json may name in
``engineFactory`` to the port's factories; ``NOT_PORTED`` names the JAX
package's other templates, which wait for ROADMAP.md, queue A,
'Remaining templates'.
"""

ENGINE_FACTORIES = {
    "recommendation": "predictionio_tpu_torch.models.recommendation.RecommendationEngine",
    "ecommerce": "predictionio_tpu_torch.models.ecommerce.ECommerceEngine",
    "similar_product": "predictionio_tpu_torch.models.similar_product.SimilarProductEngine",
    "universal_recommender":
        "predictionio_tpu_torch.models.universal_recommender.UniversalRecommenderEngine",
}

NOT_PORTED = ("classification", "text", "complementary_purchase", "product_ranking",
              "lead_scoring")
